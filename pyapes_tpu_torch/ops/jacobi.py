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
stencil; the double sweep halves the traffic of a smooth pair (read x and
b once, write z once), so its bound is the same 3 grids for twice the
work. The TPU kernels hold whole y-z planes in VMEM and march a slab along
axis 0; a Hopper block has 227 KB of shared memory, so both ports march a
column instead (2.5-D): a block owns a (j, k) column tile of outputs and a
chunk of consecutive planes along axis 0, and per plane stages x and b in
shared memory with 16-byte ``cp.async`` copies issued planes ahead of
use. A thread owns a pair of adjacent columns in four rows, read and
written as pairs (bf16x2, float2, double2); the axis-0 neighbours and the
j and k neighbours inside its points stay in registers along the march;
the wrap and the mask are resolved once per block; math in
``promote(dtype, f32)`` with one rounding on store.

* The single sweep (and its dot): 16 x 128 tiles of 256 threads; x on a
  window of rows +-1 and columns +-16 bytes, b on the tile; out(p) from
  x(p-1..p+1) and b(p). x is re-read 1.27x in bf16 (its window), mostly
  from L2.
* The double sweep: 14 x 64 tiles of 128 threads; x on rows +-2, columns
  +-8, b on rows +-1; ``y`` on the tile plus a +-1 ring into a two-plane
  ring in shared memory (in the compute dtype, never rounded, as in the
  JAX kernel), then ``z`` on the tile. x is re-read 1.61x and b 1.43x, and
  y is computed on 1.18x the outputs, where a 3-D tile with a halo on all
  six faces re-read x 2.5x and computed y on 1.66x.

The chunk length adapts to the grid and to the blocks the card holds at
once (``march_geometry``): long chunks where the column tiles alone fill
the card, short ones where they do not. A point's value is one expression
with explicit fma wherever it is computed, so chunk seams change no bits.
Dots are one partial per block (warp-shuffle tree), summed by the wrapper
with ``torch.sum`` in a fixed order: no atomics, so ``itr`` does not
change from run to run.

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
# (j, k) column tiles of the plane marches (csrc/jacobi3d.cu J1_TJ x J1_TK,
# X2_TJ x X2_TK), and a block's fixed cost in planes of its march: the
# prologue's staging (and, in the double sweep, the two y planes before
# its chunk)
_J1_TILE, _J1_SETUP_PLANES = (16, 128), 2
_X2_TILE, _X2_SETUP_PLANES = (14, 64), 4


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("jacobi3d")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.pyapes_jacobi3d.argtypes = [I] * 5 + [P] * 4 + [D] * 5 + [I] * 3 + [P]
    lib.pyapes_jacobi3d.restype = I
    lib.pyapes_jacobi3d_blocks_per_sm.argtypes = [I, I, I, ctypes.POINTER(I)]
    lib.pyapes_jacobi3d_blocks_per_sm.restype = I
    lib.pyapes_jacobi3d_x2.argtypes = [I] * 5 + [P] * 4 + [D] * 4 + [I] * 4 + [P]
    lib.pyapes_jacobi3d_x2.restype = I
    lib.pyapes_jacobi3d_x2_blocks_per_sm.argtypes = [I, I, I, ctypes.POINTER(I)]
    lib.pyapes_jacobi3d_x2_blocks_per_sm.restype = I
    return lib


def check_inputs(x, b: torch.Tensor, inv_dx2, mask_axes, grid_yz) -> None:
    """Raise on what the kernels do not take: dtype other than
    bf16/f32/f64, a shape other than ``(vdim, nx, ny, nz)``, an axis with
    fewer than 3 nodes, ``x`` (when given) of another shape, dtype or
    device, non-contiguous operands, a wrong ``inv_dx2``/``mask_axes``, a
    grid beyond the launch limits (``grid_yz``: the launch's y and z), or a
    plane of 2^31 points or more."""
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
    if b.shape[2] * b.shape[3] >= 2**31:
        raise ValueError(f"jacobi3d: a plane of {tuple(b.shape)} exceeds 2^31 points")


def _mask_bits(mask_axes) -> int:
    return sum(1 << a for a in set(mask_axes))


def _partial(b: torch.Tensor, n_blocks: int) -> torch.Tensor:
    cdt = torch.promote_types(b.dtype, torch.float32)
    return torch.empty((b.shape[0], n_blocks), dtype=cdt, device=b.device)


def _dots(partial: torch.Tensor) -> torch.Tensor:
    return partial.sum(dim=1).reshape(partial.shape[0], 1, 1, 1)


def _cuda_lib(name: str, t: torch.Tensor) -> ctypes.CDLL:
    """The library for a CUDA tensor, loaded before anything else: a CUDA
    tensor launches the kernel or raises, never the plain version."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return _lib()


@functools.lru_cache(maxsize=256)
def _chunk(n0: int, columns: int, resident: int, setup: int) -> int:
    """Planes per block along axis 0 for ``columns`` column tiles (all
    components) when the card holds ``resident`` blocks at once: the chunk
    whose launch takes the fewest plane-steps, (waves of blocks) x (planes
    a block marches + ``setup``); the longest among equals."""
    best = None
    for nch in range(1, n0 + 1):
        ci = -(-n0 // nch)
        if -(-n0 // ci) != nch:
            continue
        cost = -(-columns * nch // resident) * (ci + setup)
        if best is None or cost < best[0]:
            best = (cost, ci)
    return best[1]


def march_geometry(shape, resident: int, chunk, tile, setup):
    """Launch geometry of a plane march on a ``(vdim, n0, n1, n2)`` grid
    in ``tile`` = ``(tj, tk)`` column tiles (``_J1_TILE``, ``_X2_TILE``):
    ``(grid, chunk, partials)``. ``grid`` is ``(ceil(n2 / tk), ceil(n1 /
    tj), vdim * ceil(n0 / chunk))`` blocks; block ``(bx, by, bz)`` writes
    component ``bz // ceil(n0 / chunk)``, planes ``chunk * (bz % ceil(n0 /
    chunk))`` on (at most ``chunk`` of them), rows ``tj by`` on and columns
    ``tk bx`` on. ``chunk`` (planes per block): when None, ``_chunk``'s
    choice for a card that holds ``resident`` blocks at once, each with a
    fixed cost of ``setup`` planes (``_J1_SETUP_PLANES``,
    ``_X2_SETUP_PLANES``); given, it is taken as is. ``partials``: the dot
    partials per component, one per block."""
    vdim, n0, n1, n2 = shape
    tj, tk = tile
    gx, gy = -(-n2 // tk), -(-n1 // tj)
    if chunk is None:
        chunk = _chunk(n0, gx * gy * vdim, resident, setup)
    chunk = max(1, min(int(chunk), n0))
    nch = -(-n0 // chunk)
    return (gx, gy, vdim * nch), chunk, gx * gy * nch


@functools.lru_cache(maxsize=None)
def _resident(device: int, entry: str, dtype: torch.dtype, *flags: int) -> int:
    """Blocks of a plane march the card holds at once: its SMs times the
    blocks per SM that the kernel's registers and shared memory allow
    (from the C entry ``entry`` with the kernel's template ``flags``)."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(_DTYPE_CODE[dtype], *flags, ctypes.byref(blocks))
    cuda_build.check(lib, err, entry)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, blocks.value) * sms


def _copy_bytes(b, n2, operands) -> int:
    """Bytes per staging copy of a plane march: the widest of 16, 8, 4 (at
    least an element) that divides a row and every operand's address; 0
    (element loads) when none does (bf16 rows of odd length)."""
    size = b.element_size()
    for cw in (16, 8, 4):
        if cw >= size and n2 * size % cw == 0 and all(t.data_ptr() % cw == 0 for t in operands):
            return cw
    return 0


def _launch_jacobi(x, b, inv_dx2, alpha, beta, mask_axes, dot: bool, chunk):
    name = "jacobi3d_dot" if dot else "jacobi3d"
    lib = _cuda_lib(name, b)
    if x is None:
        raise ValueError(f"{name}: x is required")
    vdim, n0, n1, n2 = b.shape
    full = n1 % _J1_TILE[0] == 0 and n2 % _J1_TILE[1] == 0  # the kernel the launch takes
    resident = _resident(b.device.index, "pyapes_jacobi3d_blocks_per_sm", b.dtype, int(dot),
                         int(full))
    grid, chunk, n_partial = march_geometry(b.shape, resident, chunk, _J1_TILE, _J1_SETUP_PLANES)
    check_inputs(x, b, inv_dx2, mask_axes, grid[1:])
    out = torch.empty_like(b)
    partial = _partial(b, n_partial) if dot else None
    with torch.cuda.device(b.device):
        err = lib.pyapes_jacobi3d(
            _DTYPE_CODE[b.dtype], vdim, n0, n1, n2,
            x.data_ptr(), b.data_ptr(), out.data_ptr(),
            partial.data_ptr() if dot else None,
            *(float(v) for v in inv_dx2), float(alpha), float(beta),
            _mask_bits(mask_axes), chunk, _copy_bytes(b, n2, [x, b]),
            torch.cuda.current_stream(b.device).cuda_stream,
        )
    cuda_build.check(lib, err, name)
    return out, partial


def jacobi3d(x, b, inv_dx2, alpha, beta, mask_axes, chunk=None) -> torch.Tensor:
    """``alpha x + beta mask (b - A x)``; ``x``, ``b``: ``(vdim, nx, ny,
    nz)``. A CPU tensor goes to the plain ``apply_jacobi3d``; a CUDA
    tensor launches the kernel on the current stream, or raises.
    ``chunk``: planes per block (``march_geometry``'s choice when None;
    the card tests pin the chunk seams with it)."""
    if b.device.type == "cpu":
        return apply_jacobi3d(x, b, inv_dx2, alpha, beta, mask_axes)
    out, _ = _launch_jacobi(x, b, inv_dx2, alpha, beta, mask_axes, False, chunk)
    jacobi3d.launches += 1
    return out


def jacobi3d_dot(x, b, inv_dx2, alpha, beta, mask_axes, chunk=None):
    """``jacobi3d`` plus ``sum(b * out)`` per component (shaped ``(vdim,
    1, 1, 1)``, from the unrounded ``out``). CPU: the plain
    ``apply_jacobi3d_dot``; CUDA: the kernel, or raises."""
    if b.device.type == "cpu":
        return apply_jacobi3d_dot(x, b, inv_dx2, alpha, beta, mask_axes)
    out, partial = _launch_jacobi(x, b, inv_dx2, alpha, beta, mask_axes, True, chunk)
    jacobi3d_dot.launches += 1
    return out, _dots(partial)


def jacobi3d_x2(x, b, inv_dx2, beta, mask_axes, from_zero=False, emit_dot=False, chunk=None):
    """Two damped-Jacobi sweeps ``y = x + beta mask (b - A x)``, ``z = y +
    beta mask (b - A y)`` in one pass (``from_zero``: ``y = beta mask b``,
    ``x`` not read and may be None). Returns ``z``, or ``(z, sum(b * z))``
    with ``emit_dot``. CPU: the plain ``apply_jacobi3d_x2``; CUDA: the
    kernel, or raises. ``chunk``: planes per block (``march_geometry``'s
    choice when None; the card tests pin the chunk seams with it)."""
    if b.device.type == "cpu":
        return apply_jacobi3d_x2(x, b, inv_dx2, beta, mask_axes, from_zero, emit_dot)
    lib = _cuda_lib("jacobi3d_x2", b)
    vdim, n0, n1, n2 = b.shape
    resident = _resident(b.device.index, "pyapes_jacobi3d_x2_blocks_per_sm", b.dtype,
                         int(bool(from_zero)), int(bool(emit_dot)))
    grid, chunk, n_partial = march_geometry(b.shape, resident, chunk, _X2_TILE, _X2_SETUP_PLANES)
    check_inputs(None if from_zero else x, b, inv_dx2, mask_axes, grid[1:])
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
