"""Profiling / observability helpers (port of ``pyapes_tpu/utils/profile.py``).

The reference's only instrumentation is a print-based convergence report
(``linalg.py:308-312``). Here: a ``torch.profiler`` trace of the CPU and the
card, a solve-timing context manager over synchronized regions, and a
roofline estimator for stencil applies.

The default bandwidth, 3350 GB/s, is the HBM3 rate of an NVIDIA H100 80GB
HBM3 (SXM, 700 W): the figure behind the bounds of ``PERF.md`` §6. A card
capped below 700 W, or another card, needs its own ``hbm_gbps``; quote a
fraction against ``measure_achievable_bw()`` of the same card as well.
"""
from __future__ import annotations

import contextlib
import math
import os
import time

import torch

H100_HBM_GBPS = 3350.0
"""HBM3 bandwidth of the NVIDIA H100 80GB HBM3 at 700 W (GB/s)."""


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, where there is
    one, the CUDA device; on exit a Chrome trace (``*.pt.trace.json``, for
    Perfetto or TensorBoard) is written into ``logdir``. Yields the
    profiler (``key_averages()`` and friends)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"pyapes_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class SolveTimer:
    """Wall-clock timing of a region that starts and ends with the current
    CUDA device synchronized (the counterpart of the JAX package's
    ``block_until_ready``'d regions; on a CPU-only host, the plain wall).

    Example:
        >>> with SolveTimer() as t:
        ...     solver.solve()
        >>> t.elapsed
    """

    def __enter__(self):
        _sync()
        self._tic = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.elapsed = time.perf_counter() - self._tic
        return False


def stencil_roofline(nx, dtype_bytes=4, hbm_gbps=H100_HBM_GBPS):
    """Speed-of-light time (s) for one fused stencil apply: read x once +
    write out once, at ``hbm_gbps`` (default: the NVIDIA H100 80GB HBM3 at
    700 W, 3350 GB/s)."""
    n = math.prod(nx)
    bytes_moved = 2 * n * dtype_bytes
    return bytes_moved / (hbm_gbps * 1e9)


def measure_achievable_bw(n: int = 512, reps: int = 30) -> float:
    """Measured achievable read + write stream bandwidth (GB/s).

    A dependency-chained elementwise copy-scale over an ``n^3`` float32
    tensor, ``reps`` times, on the card when there is one (timed with CUDA
    events after one warm call), else on the CPU (wall clock)."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, n, n), generator=g, device=dev, dtype=torch.float32)
    o = x * 1.000001
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(reps):
            o = o * 1.000001
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / reps
    else:
        tic = time.perf_counter()
        for _ in range(reps):
            o = o * 1.000001
        dt = (time.perf_counter() - tic) / reps
    return 2 * n**3 * 4 / dt / 1e9


def bandwidth_report(nx, elapsed_s, dtype_bytes=4, hbm_gbps=H100_HBM_GBPS,
                     achievable_gbps: float | None = None):
    """Effective bandwidth and roofline fraction of a stencil apply.

    ``roofline_fraction`` is against the nominal ``hbm_gbps`` (default the
    NVIDIA H100 80GB HBM3 at 700 W, 3350 GB/s); pass ``achievable_gbps``
    (e.g. from ``measure_achievable_bw``) to also get the fraction of what
    the card demonstrably delivers on a plain copy-scale."""
    n = math.prod(nx)
    eff = 2 * n * dtype_bytes / elapsed_s
    out = {
        "effective_gbps": eff / 1e9,
        "roofline_fraction": eff / (hbm_gbps * 1e9),
    }
    if achievable_gbps:
        out["achievable_fraction"] = eff / (achievable_gbps * 1e9)
    return out
