"""Fused damped-Jacobi smoother / residual kernels of the multigrid
V-cycle: the hand-written Hopper kernels of ``csrc/jacobi3d.cu`` and their
wrappers (the port's counterpart of the Jacobi kernels of
``pyapes_tpu/ops/pallas_stencil*.py``).

* ``jacobi3d``: ``alpha x + beta mask (b - A x)`` for the 3-D central
  Laplacian with scalar per-axis ``inv_dx2`` and torus wrap on every axis;
  ``mask`` zeroes the update on the global first and last rows of each
  axis in ``mask_axes``. ``alpha=1, beta=omega/diag`` is a smooth,
  ``alpha=0, beta=1`` the masked residual. Replaces
  ``pallas_stencil.py::pallas_jacobi3d``, ``pallas_stencil_db.py::
  pallas_jacobi3d_db`` and ``pallas_stencil_v3.py::pallas_jacobi3d_v3``.
* ``jacobi3d_dot``: the same plus ``sum(b * out)`` per component — the PCG
  ``dot(r, z)`` fused into the V-cycle's last post-smooth. Replaces
  ``pallas_stencil_db.py::pallas_jacobi3d_dot_db``.
* ``jacobi3d_x2``: two sweeps in one pass (``from_zero``: the first sweep
  starts from x = 0 and x is not read; ``emit_dot``: ``sum(b * z)``).
  Replaces ``pallas_stencil_v3.py::pallas_jacobi3d_x2``.

What bounds them: a sweep does ~12 flops per point against 3 grids of
compulsory traffic (read x and b, write out) — HBM-bound, like the axis
stencil. The single-sweep kernel is one thread per point, the last axis
along ``threadIdx.x`` (coalesced), neighbour rows and planes re-read
through L1/L2, wrap and mask as index arithmetic, math in
``promote(dtype, f32)`` with one rounding on store. The double sweep halves
the traffic of a smooth pair (read x and b once, write z once): each block
owns an 8x8x32 output tile, computes ``y`` on the tile plus a +-1 halo in
ALL three axes into shared memory (the TPU slab held whole y-z planes, so
only x needed a halo there), reading x on a +-2 halo through the cache,
then ``z`` from shared ``y``; ``y`` stays in the compute dtype, as in the
JAX kernel. The halo recompute costs ~1.7x the sweep-1 arithmetic, which
is free next to the memory traffic. Dots are one partial per block
(warp-shuffle tree), summed by the wrapper with ``torch.sum`` in a fixed
order: no atomics, so ``itr`` does not change from run to run.

Each wrapper launches its kernel for a CUDA tensor (or raises) and calls
the plain version of ``ops.stencil`` for a CPU tensor; ``<fn>.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pyapes_tpu_torch.ops import cuda_build
from pyapes_tpu_torch.ops.stencil import (
    apply_jacobi3d,
    apply_jacobi3d_dot,
    apply_jacobi3d_x2,
)

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_MAX_GRID_YZ = 65535
_THREADS = 128  # single-sweep block (csrc/jacobi3d.cu kThreads)
_X2_TILE = (8, 8, 32)  # double-sweep output tile (TI, TJ, TK)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("jacobi3d")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.pyapes_jacobi3d.argtypes = [I] * 5 + [P] * 4 + [D] * 5 + [I, P]
    lib.pyapes_jacobi3d.restype = I
    lib.pyapes_jacobi3d_x2.argtypes = [I] * 5 + [P] * 4 + [D] * 4 + [I, I, P]
    lib.pyapes_jacobi3d_x2.restype = I
    return lib


def check_inputs(x, b: torch.Tensor, inv_dx2, mask_axes, grid_yz) -> None:
    """Raise on what the kernels do not take: dtype other than
    bf16/f32/f64, a shape other than ``(vdim, nx, ny, nz)``, an axis with
    fewer than 3 nodes, ``x`` (when given) of another shape, dtype or
    device, non-contiguous operands, a wrong ``inv_dx2``/``mask_axes``, or a
    grid beyond the launch limits (``grid_yz``: the launch's y and z)."""
    if b.dtype not in _DTYPE_CODE:
        raise TypeError(f"jacobi3d: dtype {b.dtype} not supported (bf16, f32, f64)")
    if b.ndim != 4:
        raise ValueError(f"jacobi3d: b must be (vdim, nx, ny, nz), got {tuple(b.shape)}")
    if min(b.shape[1:]) < 3:
        raise ValueError(f"jacobi3d: every axis needs >= 3 nodes, got {tuple(b.shape)}")
    if not b.is_contiguous():
        raise ValueError("jacobi3d: b must be contiguous")
    if x is not None and (
        x.shape != b.shape or x.dtype != b.dtype or x.device != b.device or not x.is_contiguous()
    ):
        raise ValueError("jacobi3d: x must be a contiguous tensor of b's shape, dtype and device")
    if len(inv_dx2) != 3:
        raise ValueError(f"jacobi3d: inv_dx2 needs 3 entries, got {len(inv_dx2)}")
    if any(a not in (0, 1, 2) for a in mask_axes):
        raise ValueError(f"jacobi3d: mask_axes must be mesh axes 0-2, got {mask_axes}")
    if max(grid_yz) > _MAX_GRID_YZ:
        raise ValueError(f"jacobi3d: grid {tuple(b.shape)} exceeds the launch limits")


def _mask_bits(mask_axes) -> int:
    return sum(1 << a for a in set(mask_axes))


def _partial(b: torch.Tensor, n_blocks: int) -> torch.Tensor:
    cdt = torch.promote_types(b.dtype, torch.float32)
    return torch.empty((b.shape[0], n_blocks), dtype=cdt, device=b.device)


def _dots(partial: torch.Tensor) -> torch.Tensor:
    return partial.sum(dim=1).reshape(partial.shape[0], 1, 1, 1)


def _launch_jacobi(lib, x, b, inv_dx2, alpha, beta, mask_axes, dot: bool):
    if x is None:
        raise ValueError("jacobi3d: x is required")
    vdim, n0, n1, n2 = b.shape
    check_inputs(x, b, inv_dx2, mask_axes, (n1, vdim * n0))
    out = torch.empty_like(b)
    partial = _partial(b, n0 * n1 * -(-n2 // _THREADS)) if dot else None
    with torch.cuda.device(b.device):
        err = lib.pyapes_jacobi3d(
            _DTYPE_CODE[b.dtype], vdim, n0, n1, n2,
            x.data_ptr(), b.data_ptr(), out.data_ptr(),
            partial.data_ptr() if dot else None,
            *(float(v) for v in inv_dx2), float(alpha), float(beta),
            _mask_bits(mask_axes), torch.cuda.current_stream(b.device).cuda_stream,
        )
    cuda_build.check(lib, err, "jacobi3d_dot" if dot else "jacobi3d")
    return out, partial


def _cuda_lib(name: str, t: torch.Tensor) -> ctypes.CDLL:
    """The library for a CUDA tensor, loaded before anything else: a CUDA
    tensor launches the kernel or raises, never the plain version."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return _lib()


def jacobi3d(x, b, inv_dx2, alpha, beta, mask_axes) -> torch.Tensor:
    """``alpha x + beta mask (b - A x)``; ``x``, ``b``: ``(vdim, nx, ny,
    nz)``. A CPU tensor goes to the plain ``apply_jacobi3d``; a CUDA
    tensor launches the kernel on the current stream, or raises."""
    if b.device.type == "cpu":
        return apply_jacobi3d(x, b, inv_dx2, alpha, beta, mask_axes)
    lib = _cuda_lib("jacobi3d", b)
    out, _ = _launch_jacobi(lib, x, b, inv_dx2, alpha, beta, mask_axes, dot=False)
    jacobi3d.launches += 1
    return out


def jacobi3d_dot(x, b, inv_dx2, alpha, beta, mask_axes):
    """``jacobi3d`` plus ``sum(b * out)`` per component (shaped ``(vdim,
    1, 1, 1)``, from the unrounded ``out``). CPU: the plain
    ``apply_jacobi3d_dot``; CUDA: the kernel, or raises."""
    if b.device.type == "cpu":
        return apply_jacobi3d_dot(x, b, inv_dx2, alpha, beta, mask_axes)
    lib = _cuda_lib("jacobi3d_dot", b)
    out, partial = _launch_jacobi(lib, x, b, inv_dx2, alpha, beta, mask_axes, dot=True)
    jacobi3d_dot.launches += 1
    return out, _dots(partial)


def jacobi3d_x2(x, b, inv_dx2, beta, mask_axes, from_zero=False, emit_dot=False):
    """Two damped-Jacobi sweeps ``y = x + beta mask (b - A x)``, ``z = y +
    beta mask (b - A y)`` in one pass (``from_zero``: ``y = beta mask b``,
    ``x`` not read and may be None). Returns ``z``, or ``(z, sum(b * z))``
    with ``emit_dot``. CPU: the plain ``apply_jacobi3d_x2``; CUDA: the
    kernel, or raises."""
    if b.device.type == "cpu":
        return apply_jacobi3d_x2(x, b, inv_dx2, beta, mask_axes, from_zero, emit_dot)
    lib = _cuda_lib("jacobi3d_x2", b)
    vdim, n0, n1, n2 = b.shape
    ti, tj, tk = _X2_TILE
    gx, gy, gz = -(-n2 // tk), -(-n1 // tj), vdim * -(-n0 // ti)
    check_inputs(None if from_zero else x, b, inv_dx2, mask_axes, (gy, gz))
    out = torch.empty_like(b)
    partial = _partial(b, gx * gy * (gz // vdim)) if emit_dot else None
    with torch.cuda.device(b.device):
        err = lib.pyapes_jacobi3d_x2(
            _DTYPE_CODE[b.dtype], vdim, n0, n1, n2,
            None if from_zero else x.data_ptr(), b.data_ptr(), out.data_ptr(),
            partial.data_ptr() if emit_dot else None,
            *(float(v) for v in inv_dx2), float(beta),
            _mask_bits(mask_axes), int(bool(from_zero)),
            torch.cuda.current_stream(b.device).cuda_stream,
        )
    cuda_build.check(lib, err, "jacobi3d_x2")
    jacobi3d_x2.launches += 1
    if emit_dot:
        return out, _dots(partial)
    return out


jacobi3d.launches = 0
jacobi3d_dot.launches = 0
jacobi3d_x2.launches = 0
