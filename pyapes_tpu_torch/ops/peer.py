"""Copies between cards inside per-card CUDA graphs: the hand-written
kernels of ``csrc/peer.cu`` and their wrappers. They replace no Pallas
kernel: they are the port's counterpart of the ``ppermute`` / ``psum``
transfers that XLA inserts between the chips of the JAX package's
decomposed solve (``parallel/blocks.py``'s ``transfer`` calls them).

* ``peer_put(src, dst, ch)``: ``dst.copy_(src)`` where ``dst`` lies on
  another card (or, on one card, is read by another stream): a strided
  copy of up to 4 dimensions stored straight into the destination's
  memory through its peer pointer, on the source card's current stream.
* ``peer_wait(ch)``: on the destination card's current stream, holds that
  stream until the put of the same transfer has landed.

A transfer site is a ``Channel``: five 64-bit counters in device memory,
three on the source card and two on the destination card, zeroed once
and never reset, so one channel serves every pass of a WHILE loop and
every replay. Write-after-read is handled by an acknowledgement counter,
not by double buffering: the wait first tells the source that the
destination's stream has reached the transfer (every earlier reader of
the destination memory has ended), and the put writes only then
(``csrc/peer.cu`` spells out the protocol). Both spins are bounded by
``TIMEOUT_S`` of the device clock; on expiry the kernel traps and the next
host synchronisation raises, so a lost peer never hangs the process.

The plain versions (a CPU tensor, the tests): ``peer_put`` is
``dst.copy_(src)`` and ``peer_wait`` does nothing. On a CUDA tensor the
wrappers launch their kernel or raise. ``<fn>.launches`` counts kernel
launches (a Python count: a launch captured into a CUDA graph counts at
the capture, not at a replay).
"""
from __future__ import annotations

import ctypes

import torch

from pyapes_tpu_torch.utils.debug import record_kernel

TIMEOUT_S = 10.0
"""How long a put or a wait spins on its peer before it traps."""

_BLOCK_BYTES = 256 * 16  # bytes of one put block's share before the grid grows
_MAX_BLOCKS = 264  # two blocks per SM of an H100


def _lib():
    from pyapes_tpu_torch.ops import cuda_build

    lib = cuda_build.load("peer")
    if not getattr(lib, "_typed", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        arr = ctypes.POINTER(ll)
        lib.pyapes_peer_put.argtypes = [vp, vp, vp, ctypes.c_int, arr, arr, arr, vp, vp, vp, vp,
                                        ll, ctypes.c_int]
        lib.pyapes_peer_wait.argtypes = [vp, vp, vp, vp, ll]
        lib.pyapes_peer_enable.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.pyapes_peer_preload.argtypes = []
        for f in (lib.pyapes_peer_put, lib.pyapes_peer_wait, lib.pyapes_peer_enable,
                  lib.pyapes_peer_preload):
            f.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"peer: {what} failed: {lib.pyapes_cuda_error_string(err).decode()} "
                           f"({err})")


_ENABLED: set = set()
_LOADED: set = set()


def _loaded(device: torch.device):
    """The library, its kernels loaded on ``device`` (once per device: a
    put launched behind a spinning wait must not load its module then,
    ``csrc/peer.cu``)."""
    lib = _lib()
    if device.index not in _LOADED:
        with torch.cuda.device(device):
            _check(lib, lib.pyapes_peer_preload(), f"loading the kernels on {device}")
        _LOADED.add(device.index)
    return lib


def enable_peer_access(devices) -> None:
    """Enable peer access between every pair of the distinct cards in
    ``devices`` (``cudaDeviceEnablePeerAccess``; one already enabled is
    fine); raises ``RuntimeError`` where a pair cannot reach each other
    (``torch.cuda.can_device_access_peer``): there is no fallback."""
    idx = sorted({torch.device(d).index for d in devices if torch.device(d).type == "cuda"})
    for a in idx:
        for b in idx:
            if a == b or (a, b) in _ENABLED:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(f"peer: cuda:{a} cannot access cuda:{b}'s memory (no peer "
                                   "access); a graph across these cards cannot be built")
            lib = _lib()
            _check(lib, lib.pyapes_peer_enable(a, b), f"enabling peer access cuda:{a} -> cuda:{b}")
            _ENABLED.add((a, b))


class Channel:
    """One transfer site's counters (see the module docstring): ``src``
    holds cts, sent, done on the source device, ``dst`` arrived, seen on
    the destination device; views of zeroed int64 tensors that the caller
    keeps alive (``graph_loop.counter_slots``)."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor):
        if src.numel() != 3 or dst.numel() != 2:
            raise ValueError("peer.Channel: 3 counters on the source, 2 on the destination")
        self.src, self.dst = src, dst

    @classmethod
    def make(cls, src_device, dst_device) -> "Channel":
        """A channel between two devices, its counters from
        ``graph_loop.counter_slots`` (a capture's pool, or fresh zeros)."""
        from pyapes_tpu_torch.ops.graph_loop import counter_slots

        return cls(counter_slots(src_device, 3), counter_slots(dst_device, 2))


def _slabs(src: torch.Tensor, dst: torch.Tensor) -> tuple:
    """``(shape, src strides, dst strides)`` of a copy, padded to 4
    dimensions (leading extents 1): dimensions of extent 1 dropped and
    neighbours that both tensors hold as one run of memory merged, so a
    stack of partials or a whole block takes few dimensions."""
    dims = [(n, a, b) for n, a, b in zip(src.shape, src.stride(), dst.stride()) if n != 1]
    merged: list = []
    for n, a, b in dims:
        if merged and merged[-1][1] == a * n and merged[-1][2] == b * n:
            m = merged.pop()
            merged.append((m[0] * n, a, b))
        else:
            merged.append((n, a, b))
    if len(merged) > 4:
        raise ValueError(f"peer: a copy of {tuple(src.shape)} takes more than 4 strided "
                         "dimensions")
    merged = [(1, 0, 0)] * (4 - len(merged)) + merged
    return tuple(zip(*merged))


def _ll4(vals):
    return (ctypes.c_longlong * 4)(*vals)


def check_inputs(src: torch.Tensor, dst: torch.Tensor) -> None:
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"peer_put: {tuple(src.shape)} {src.dtype} into {tuple(dst.shape)} "
                         f"{dst.dtype}")
    if src.device.type != dst.device.type:
        raise ValueError(f"peer_put: {src.device} into {dst.device}")


def peer_put(src: torch.Tensor, dst: torch.Tensor, ch: Channel | None = None) -> None:
    """``dst.copy_(src)`` through the channel ``ch`` (see the module
    docstring): on the CPU the copy itself; on the card the kernel on the
    source card's current stream, which waits for the matching
    ``peer_wait``'s go-ahead and must not share its stream."""
    check_inputs(src, dst)
    if src.device.type == "cpu":
        dst.copy_(src)
        return
    if ch is None:
        raise ValueError("peer_put: a CUDA put needs its Channel")
    shape, ss, ds = _slabs(src, dst)
    n = src.numel()
    blocks = max(1, min(_MAX_BLOCKS, -(-n * src.element_size() // _BLOCK_BYTES)))
    lib = _loaded(src.device)
    _loaded(dst.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device)
        _check(lib, lib.pyapes_peer_put(
            stream.cuda_stream, src.data_ptr(), dst.data_ptr(), src.element_size(), _ll4(shape),
            _ll4(ss), _ll4(ds), ch.src[0:1].data_ptr(), ch.src[1:2].data_ptr(),
            ch.src[2:3].data_ptr(), ch.dst[0:1].data_ptr(), int(TIMEOUT_S * 1e9), blocks),
            "the put launch")
    peer_put.launches += 1
    record_kernel("peer_put", dst)


def peer_wait(ch: Channel | None, device=None) -> None:
    """Hold the destination card's current stream until the put of ``ch``
    has landed (a no-op on the CPU: ``device`` "cpu" or ``ch`` None)."""
    if ch is None or torch.device(device if device is not None else ch.dst.device).type == "cpu":
        return
    dev = ch.dst.device
    lib = _loaded(dev)
    _loaded(ch.src.device)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        _check(lib, lib.pyapes_peer_wait(stream.cuda_stream, ch.src[0:1].data_ptr(),
                                         ch.dst[0:1].data_ptr(), ch.dst[1:2].data_ptr(),
                                         int(TIMEOUT_S * 1e9)), "the wait launch")
    peer_wait.launches += 1


def plain_put(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The plain version of ``peer_put`` followed by ``peer_wait``."""
    return dst.copy_(src)


peer_put.launches = 0
peer_wait.launches = 0
