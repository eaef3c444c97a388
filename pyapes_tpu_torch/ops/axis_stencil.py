"""Per-axis 3-point stencil apply, and the apply fused with the CG
alpha-dot: the hand-written Hopper kernels and their wrappers (the port's
counterpart of the axis-stencil kernels of ``pyapes_tpu/ops/pallas_stencil*.py``).

``axis_stencil`` replaces three Pallas TPU kernels that compute one
function — ``pallas_stencil.py::pallas_axis_stencil`` (2-D and 3-D tiled),
``pallas_stencil_db.py::pallas_axis_stencil_db`` (3-D, double-buffered
ghost DMAs) and ``pallas_stencil_v3.py::pallas_axis_stencil_v3`` (3-D,
slab-resident) — with ONE CUDA kernel, ``csrc/axis_stencil.cu``, for any
grid of at least 3 nodes per axis: the TPU's (8, 128) tiling gates,
pad-and-crop and in-register row selection do not apply on the card.
``axis_stencil_dot`` replaces ``pallas_stencil_db.py::pallas_axis_stencil_dot``
and ``pallas_stencil_v3.py::pallas_axis_stencil_dot_v3`` (3-D): the same
apply plus ``sum(x * A x)`` per component, so CG never re-reads ``d`` and
``A d`` for its alpha-dot.

What bounds them: the apply does ~7 multiply-adds per point against 2-4
bytes each way (bf16/f32) of compulsory traffic (read x, write out), far
below the card's FLOP-to-byte balance — they are HBM-bound, and the floor
is about two grids of device-memory traffic per apply. The design aims at
that traffic without shared-memory tiling: one thread per output point
with the last axis along ``threadIdx.x``, so the centre, +-1 last-axis and
output accesses coalesce; the +-1 rows and planes are re-reads that
consecutive blocks (which walk the grid in memory order) find in L1/L2
(50 MB holds dozens of 512^2 planes), so x is fetched from HBM about once.
The torus wrap is index arithmetic, the per-axis coefficient vectors are a
few KB read through the cache, and the sum accumulates in
``promote(dtype, f32)`` (bf16 is loaded, widened to f32 and rounded once
on store). The dot kernel reduces each 128-thread block with warp shuffles
into one partial; the wrapper sums the partials with ``torch.sum`` in a
fixed order (no atomics, so a solve's ``itr`` is the same every run).
``cp.async``/TMA plane tiling is later work.

Each wrapper launches its kernel for a CUDA tensor (or raises) and calls
the plain version of ``ops.stencil`` for a CPU tensor; ``<fn>.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pyapes_tpu_torch.ops import cuda_build
from pyapes_tpu_torch.ops.stencil import apply_axis_stencil, apply_axis_stencil_dot

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_MAX_GRID_YZ = 65535  # CUDA limit on gridDim.y / gridDim.z
_THREADS = 128  # threads per block of both kernels (csrc/axis_stencil.cu)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("axis_stencil")
    P = ctypes.c_void_p
    lib.pyapes_axis_stencil.argtypes = [ctypes.c_int] * 6 + [P, P, ctypes.POINTER(P), P]
    lib.pyapes_axis_stencil.restype = ctypes.c_int
    lib.pyapes_axis_stencil_dot.argtypes = [ctypes.c_int] * 5 + [P, P, P, ctypes.POINTER(P), P]
    lib.pyapes_axis_stencil_dot.restype = ctypes.c_int
    return lib


def check_inputs(coeffs, x: torch.Tensor) -> None:
    """Raise on what the kernels do not take: dtype other than
    bf16/f32/f64, 1-3 mesh axes, a non-contiguous ``x``, a 5-point axis,
    coefficient vectors of the wrong length, dtype, device or layout, an
    axis with fewer than 3 nodes, or a grid beyond the launch limits."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"axis_stencil: dtype {x.dtype} not supported (bf16, f32, f64)")
    ndim = x.ndim - 1
    if not 1 <= ndim <= 3:
        raise ValueError(f"axis_stencil: x must be (vdim, *nx) with 1-3 mesh axes, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("axis_stencil: x must be contiguous")
    if len(coeffs) != ndim:
        raise ValueError(f"axis_stencil: {len(coeffs)} coefficient axes for {ndim} mesh axes")
    for a, cs in enumerate(coeffs):
        if len(cs) != 3:
            raise NotImplementedError(
                "axis_stencil: 5-point (QUICK) axes are ported in a later slice"
            )
        n = x.shape[1 + a]
        if n < 3:
            raise ValueError(f"axis_stencil: axis {a} has {n} < 3 nodes")
        for c in cs:
            if c.ndim != 1 or c.shape[0] != n:
                raise ValueError(f"axis_stencil: axis {a} coefficients must be 1-D of length {n}")
            if c.dtype != x.dtype or c.device != x.device or not c.is_contiguous():
                raise ValueError(
                    f"axis_stencil: axis {a} coefficients must be contiguous "
                    f"{x.dtype} on {x.device}"
                )
    n_mid = x.shape[-2] if ndim >= 2 else 1
    n_slab = x.shape[0] * (x.shape[1] if ndim == 3 else 1)
    if n_mid > _MAX_GRID_YZ or n_slab > _MAX_GRID_YZ:
        raise ValueError(f"axis_stencil: grid {tuple(x.shape)} exceeds the launch limits")


def _cuda_launch_args(fn_name: str, coeffs, x: torch.Tensor):
    """The library (loading it first: a CUDA tensor never falls back to the
    plain version), then the checked coefficient pointers and stream."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {x.device}")
    lib = _lib()
    check_inputs(coeffs, x)
    ptrs = [c.data_ptr() for cs in coeffs for c in cs] + [0] * (3 * (4 - x.ndim))
    return lib, (ctypes.c_void_p * 9)(*ptrs), torch.cuda.current_stream(x.device).cuda_stream


def axis_stencil(coeffs, x: torch.Tensor) -> torch.Tensor:
    """``sum_a ap_a x[+1] + ac_a x + am_a x[-1]`` over mesh axes, torus wrap.

    Args:
        coeffs: per mesh axis, a 3-tuple of 1-D tensors ``(ap, ac, am)``.
        x: field values ``(vdim, *nx)``.

    A CPU tensor goes to the plain ``apply_axis_stencil``; a CUDA tensor
    launches the kernel on the current stream, or raises."""
    if x.device.type == "cpu":
        return apply_axis_stencil(coeffs, x)
    lib, cptrs, stream = _cuda_launch_args("axis_stencil", coeffs, x)
    ndim = x.ndim - 1
    n = list(x.shape[1:]) + [1] * (3 - ndim)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.pyapes_axis_stencil(
            _DTYPE_CODE[x.dtype], ndim, x.shape[0], *n,
            x.data_ptr(), out.data_ptr(), cptrs, stream,
        )
    cuda_build.check(lib, err, "axis_stencil")
    axis_stencil.launches += 1
    return out


def axis_stencil_dot(coeffs, x: torch.Tensor):
    """``(A x, sum(x * A x))`` per component for a 3-D ``x``; the dot is
    taken in ``promote(dtype, f32)`` from the unrounded ``A x`` and comes
    back shaped ``(vdim, 1, 1, 1)``.

    A CPU tensor goes to the plain ``apply_axis_stencil_dot``; a CUDA
    tensor launches the kernel on the current stream, or raises."""
    if x.device.type == "cpu":
        return apply_axis_stencil_dot(coeffs, x)
    lib, cptrs, stream = _cuda_launch_args("axis_stencil_dot", coeffs, x)
    if x.ndim != 4:
        raise ValueError(f"axis_stencil_dot: x must be (vdim, nx, ny, nz), got {tuple(x.shape)}")
    vdim, n0, n1, n2 = x.shape
    out = torch.empty_like(x)
    cdt = torch.promote_types(x.dtype, torch.float32)
    partial = torch.empty((vdim, n0 * n1 * -(-n2 // _THREADS)), dtype=cdt, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.pyapes_axis_stencil_dot(
            _DTYPE_CODE[x.dtype], vdim, n0, n1, n2,
            x.data_ptr(), out.data_ptr(), partial.data_ptr(), cptrs, stream,
        )
    cuda_build.check(lib, err, "axis_stencil_dot")
    axis_stencil_dot.launches += 1
    return out, partial.sum(dim=1).reshape(vdim, 1, 1, 1)


axis_stencil.launches = 0
axis_stencil_dot.launches = 0
