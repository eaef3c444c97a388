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

What bounds them: a sweep does ~16 flops per point against 3 grids of
compulsory traffic (read x and b, write out) — HBM-bound, like the axis
stencil. The single-sweep kernel is one thread per point, the last axis
along ``threadIdx.x`` (coalesced), neighbour rows and planes re-read
through L1/L2, wrap and mask as index arithmetic, math in
``promote(dtype, f32)`` with one rounding on store.

The double sweep halves the traffic of a smooth pair (read x and b once,
write z once), so its bound is the same 3 grids for twice the work. The
TPU kernel holds whole y-z planes of x in VMEM and marches a slab along
axis 0; a Hopper block has 227 KB of shared memory, so the port marches
a column instead (2.5-D): each block owns a 14 x 64 (j, k) tile of
outputs and a chunk of consecutive planes along axis 0, and per plane
stages x (rows +-2, columns +-8) and b (+-1, +-8) in shared memory with
16-byte ``cp.async`` copies issued two planes ahead, computes ``y`` on
the tile plus a +-1 ring into a two-plane ring in shared memory (in the
compute dtype, never rounded, as in the JAX kernel), then ``z`` on the
tile. A thread owns a pair of adjacent columns in four rows, read and
written as pairs; the axis-0 neighbours and the j and k neighbours
inside its points stay in registers along the march; the wrap and the
mask are resolved once per block. x is re-read 1.61x (its window) and b
1.43x, mostly from L2, and y is computed on 1.18x the outputs, where a
3-D tile with a halo on all six faces re-read x 2.5x and computed y on
1.66x. The chunk length adapts to the grid and to the blocks the card
holds at once (``x2_geometry``): long chunks where the column tiles alone
fill the card, short ones where they do not. Dots are one partial per
block (warp-shuffle tree), summed by the wrapper with ``torch.sum`` in a
fixed order: no atomics, so ``itr`` does not change from run to run.

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
_X2_TILE = (14, 64)  # double-sweep (j, k) column tile (csrc/jacobi3d.cu X2_TJ, X2_TK)
# a double-sweep block's fixed cost in planes of its march: the prologue's
# staging and the two y planes before its chunk
_X2_SETUP_PLANES = 4


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("jacobi3d")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.pyapes_jacobi3d.argtypes = [I] * 5 + [P] * 4 + [D] * 5 + [I, P]
    lib.pyapes_jacobi3d.restype = I
    lib.pyapes_jacobi3d_x2.argtypes = [I] * 5 + [P] * 4 + [D] * 4 + [I] * 4 + [P]
    lib.pyapes_jacobi3d_x2.restype = I
    lib.pyapes_jacobi3d_x2_blocks_per_sm.argtypes = [I, I, I, ctypes.POINTER(I)]
    lib.pyapes_jacobi3d_x2_blocks_per_sm.restype = I
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


@functools.lru_cache(maxsize=256)
def _x2_chunk(n0: int, columns: int, resident: int) -> int:
    """Planes per block along axis 0 for ``columns`` column tiles (all
    components) when the card holds ``resident`` blocks at once: the chunk
    whose launch takes the fewest plane-steps, (waves of blocks) x (planes
    a block marches + ``_X2_SETUP_PLANES``); the longest among equals."""
    best = None
    for nch in range(1, n0 + 1):
        ci = -(-n0 // nch)
        if -(-n0 // ci) != nch:
            continue
        cost = -(-columns * nch // resident) * (ci + _X2_SETUP_PLANES)
        if best is None or cost < best[0]:
            best = (cost, ci)
    return best[1]


def x2_geometry(shape, resident: int, chunk=None):
    """Launch geometry of the double sweep on a ``(vdim, n0, n1, n2)``
    grid: ``(grid, chunk, partials)``. ``grid`` is ``(ceil(n2 / 64),
    ceil(n1 / 14), vdim * ceil(n0 / chunk))`` blocks; block ``(bx, by,
    bz)`` writes component ``bz // ceil(n0 / chunk)``, planes ``chunk *
    (bz % ceil(n0 / chunk))`` on (at most ``chunk`` of them), rows ``14
    by`` on and columns ``64 bx`` on. ``chunk`` (planes per block) is
    ``_x2_chunk``'s choice for a card that holds ``resident`` blocks at
    once; given, it is taken as is. ``partials``: the dot partials per
    component, one per block."""
    vdim, n0, n1, n2 = shape
    tj, tk = _X2_TILE
    gx, gy = -(-n2 // tk), -(-n1 // tj)
    if chunk is None:
        chunk = _x2_chunk(n0, gx * gy * vdim, resident)
    chunk = max(1, min(int(chunk), n0))
    nch = -(-n0 // chunk)
    return (gx, gy, vdim * nch), chunk, gx * gy * nch


@functools.lru_cache(maxsize=None)
def _x2_resident(device: int, dtype: torch.dtype, from_zero: bool, emit_dot: bool) -> int:
    """Double-sweep blocks the card holds at once: its SMs times the
    blocks per SM that the kernel's registers and shared memory allow."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.pyapes_jacobi3d_x2_blocks_per_sm(
            _DTYPE_CODE[dtype], int(from_zero), int(emit_dot), ctypes.byref(blocks))
    cuda_build.check(lib, err, "jacobi3d_x2 occupancy")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, blocks.value) * sms


def _copy_bytes(b, n2, operands) -> int:
    """Bytes per staging copy of the double sweep: the widest of 16, 8, 4
    (at least an element) that divides a row and every operand's address;
    0 (element loads) when none does (bf16 rows of odd length)."""
    size = b.element_size()
    for cw in (16, 8, 4):
        if cw >= size and n2 * size % cw == 0 and all(t.data_ptr() % cw == 0 for t in operands):
            return cw
    return 0


def jacobi3d_x2(x, b, inv_dx2, beta, mask_axes, from_zero=False, emit_dot=False, chunk=None):
    """Two damped-Jacobi sweeps ``y = x + beta mask (b - A x)``, ``z = y +
    beta mask (b - A y)`` in one pass (``from_zero``: ``y = beta mask b``,
    ``x`` not read and may be None). Returns ``z``, or ``(z, sum(b * z))``
    with ``emit_dot``. CPU: the plain ``apply_jacobi3d_x2``; CUDA: the
    kernel, or raises. ``chunk``: planes per block (``x2_geometry``'s
    choice when None; the card tests pin the chunk seams with it)."""
    if b.device.type == "cpu":
        return apply_jacobi3d_x2(x, b, inv_dx2, beta, mask_axes, from_zero, emit_dot)
    lib = _cuda_lib("jacobi3d_x2", b)
    vdim, n0, n1, n2 = b.shape
    resident = _x2_resident(b.device.index, b.dtype, bool(from_zero), bool(emit_dot))
    grid, chunk, n_partial = x2_geometry(b.shape, resident, chunk)
    check_inputs(None if from_zero else x, b, inv_dx2, mask_axes, grid[1:])
    if n1 * n2 >= 2**31:
        raise ValueError(f"jacobi3d_x2: a plane of {tuple(b.shape)} exceeds 2^31 points")
    cw = _copy_bytes(b, n2, [b] if from_zero else [x, b])
    out = torch.empty_like(b)
    partial = _partial(b, n_partial) if emit_dot else None
    with torch.cuda.device(b.device):
        err = lib.pyapes_jacobi3d_x2(
            _DTYPE_CODE[b.dtype], vdim, n0, n1, n2,
            None if from_zero else x.data_ptr(), b.data_ptr(), out.data_ptr(),
            partial.data_ptr() if emit_dot else None,
            *(float(v) for v in inv_dx2), float(beta),
            _mask_bits(mask_axes), int(bool(from_zero)), chunk, cw,
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
