"""Variable-coefficient (heterogeneous-diffusivity) diffusion kernels: the
hand-written Hopper kernels of ``csrc/diff_field.cu`` and their wrappers
(the port's counterpart of ``pyapes_tpu/ops/pallas_advect.py``'s
variable-Γ pair).

* ``diff_field``: the conservative ``∂_j (Γ ∂_j x)`` with arithmetic or
  harmonic face values and the Neumann boundary-node elimination.
  Replaces ``pallas_advect.py::pallas_diff_field``.
* ``diff_jacobi``: one variable-Γ V-cycle pass, ``smooth`` ``x + omega
  mask (b - A x) / diag``, ``smooth0`` ``omega mask b / diag`` or
  ``resid`` ``mask (b - A x)``, the diagonal rebuilt in registers from the
  same face values. Replaces ``pallas_advect.py::pallas_diff_jacobi``.

What bounds them: ~35 flops per point against 3 grids of compulsory
traffic for ``diff_field`` (read x and Γ, write out) and 4 for
``diff_jacobi`` (x, Γ, b, out) — HBM-bound, like the other stencils. Two
hand-written kernels compute both, chosen by the shape alone
(``uses_march``), never by a failure:

* the plane march (3-D grids of at least ``MARCH_MIN_POINTS`` points per
  component): ``ops/jacobi.py``'s single-sweep design with Γ staged beside
  x. A block owns a ``(tj, 128)`` column tile (``_VG_TILE``: 16 rows, 8
  in f64) and a chunk of planes along axis 0; x and Γ are staged with
  16-byte ``cp.async`` copies on a ±1-row, ±16-byte-column window (a
  stacked Γ: Γ_0 on the tile, Γ_1 and Γ_2 on the window), b on the tile,
  planes ahead of use; a thread keeps x, Γ_0 and the axis-0 face of its
  points along the march, so every face is computed once; wrap, surgery
  and mask are resolved once per block or plane. The chunk follows
  ``ops/march.py``'s ``march_geometry``.
* the per-point kernel (smaller grids, where a launch is latency, and 2-D
  grids): one thread per point, the last axis along ``threadIdx.x``,
  neighbour rows and planes of x and Γ re-read through L1/L2.

Both compute in ``promote(dtype, f32)`` with one rounding on store, wrap
every neighbour (torus) as the plain versions' ``torch.roll``, and take
every 2-D or 3-D grid of at least 3 nodes per axis, stacked
(anisotropic) Γ too, as one Γ pointer per axis. The TPU kernels' gates
(lane-aligned last axis, VMEM slab sizes) are not carried over. A march
point is one expression with explicit fma, so chunk seams change no bits.

Each wrapper launches a kernel for a CUDA tensor (or raises) and calls the
plain version of ``ops.stencil`` for a CPU tensor; ``<fn>.launches``
counts kernel launches (a Python count: a launch captured into a CUDA
graph counts at the warm-up and at the capture, not at a replay).
``march=True``/``False`` forces either kernel at
any shape and ``chunk=`` the march's planes per block (tests and
``chip_smoke.py`` pin both with them).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pyapes_tpu_torch.ops import cuda_build
from pyapes_tpu_torch.ops.march import copy_bytes, march_geometry, resident_blocks
from pyapes_tpu_torch.ops.stencil import apply_diff_field, apply_diff_jacobi
from pyapes_tpu_torch.utils.debug import record_kernel

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_MODES = {"smooth": 0, "smooth0": 1, "resid": 2}
_APPLY = 3  # the march's mode code of diff_field
_AVG = {"arithmetic": 0, "harmonic": 1}
_KINDS = ("none", "neumann")
_MAX_GRID_YZ = 65535
_POINT_THREADS = 128  # the per-point kernel's block, along the last axis
# (j, k) column tile of the march per dtype (csrc/diff_march.cu vg_tj() x
# VG_TK) and a block's fixed cost in planes (its prologue's staging)
_VG_TILE = {torch.bfloat16: (16, 128), torch.float32: (16, 128), torch.float64: (8, 128)}
_VG_SETUP_PLANES = 2
# the least points per component of a grid that the march takes: below it
# the per-point kernel, whose launch costs less. On the Darcy 256^3
# cycle's levels (PERF.md) the march is the faster from 64^3 up when timed
# back to back, but inside the solve (profiler) only from 128^3: a march
# launch there takes ~3 us longer than back to back
MARCH_MIN_POINTS = 128**3


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("diff_field")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.pyapes_diff_field.argtypes = [I] * 6 + [P] * 5 + [D] * 3 + [I] * 5 + [P]
    lib.pyapes_diff_field.restype = I
    lib.pyapes_diff_jacobi.argtypes = [I] * 7 + [P] * 6 + [D] * 4 + [I] * 6 + [P]
    lib.pyapes_diff_jacobi.restype = I
    lib.pyapes_diff_jacobi_blocks_per_sm.argtypes = [I] * 5 + [ctypes.POINTER(I)]
    lib.pyapes_diff_jacobi_blocks_per_sm.restype = I
    return lib


def uses_march(shape) -> bool:
    """The kernel a ``(vdim, *nx)`` operand takes, from its shape alone:
    the plane march for a 3-D grid of at least ``MARCH_MIN_POINTS`` points
    per component, else the per-point kernel (2-D grids, small levels)."""
    nx = tuple(shape[1:])
    return len(nx) == 3 and nx[0] * nx[1] * nx[2] >= MARCH_MIN_POINTS


def march_full(shape, dtype: torch.dtype) -> bool:
    """Every march tile lies inside the grid of a ``(vdim, *nx)`` operand
    (the march's ``FULL`` instance, compile-time window bounds)."""
    tj, tk = _VG_TILE[dtype]
    return shape[-2] % tj == 0 and shape[-1] % tk == 0


def check_inputs(name, x, b, g, inv_dx2, surgery, avg, mask_axes=()) -> None:
    """Raise on what the kernels do not take: ``b`` (the operand that
    fixes shape, dtype and device) of a dtype other than bf16/f32/f64, of
    a shape other than ``(vdim, *nx)`` with a 2-D or 3-D grid of >= 3
    nodes per axis, or not contiguous; ``x`` (when given) and ``g`` of
    another dtype or device, or not contiguous; ``x`` of another shape;
    ``g`` not ``nx`` (isotropic) or ``(dim, *nx)`` (stacked); a wrong
    ``inv_dx2``, ``surgery`` (kinds "none"/"neumann"), ``avg`` or
    ``mask_axes``. The launch limits of each kernel's grid are checked at
    its launch (``_launch``)."""
    if b.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {b.dtype} not supported (bf16, f32, f64)")
    nd = b.ndim - 1
    if nd not in (2, 3):
        raise ValueError(f"{name}: needs a (vdim, *nx) operand on a 2-D or 3-D grid, "
                         f"got {tuple(b.shape)}")
    nx = tuple(b.shape[1:])
    if min(nx) < 3:
        raise ValueError(f"{name}: every axis needs >= 3 nodes, got {nx}")
    for t, what in ((b, "b"), (x, "x"), (g, "gamma")):
        if t is None:
            continue
        if t.dtype != b.dtype or t.device != b.device:
            raise TypeError(f"{name}: {what} must have the operand's dtype {b.dtype} and "
                            f"device {b.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if x is not None and x.shape != b.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)} and b {tuple(b.shape)} differ in shape")
    if tuple(g.shape) not in (nx, (nd, *nx)):
        raise ValueError(f"{name}: gamma must be {nx} or {(nd, *nx)}, got {tuple(g.shape)}")
    if len(inv_dx2) != nd or len(surgery) != nd:
        raise ValueError(f"{name}: inv_dx2 and surgery need {nd} entries")
    if any(k not in _KINDS for pair in surgery for k in pair):
        raise ValueError(f"{name}: surgery kinds must be {_KINDS}, got {surgery}")
    if avg not in _AVG:
        raise ValueError(f"{name}: avg must be one of {tuple(_AVG)}, got {avg!r}")
    if any(a not in range(nd) for a in mask_axes):
        raise ValueError(f"{name}: mask_axes must be mesh axes 0-{nd - 1}, got {mask_axes}")


def _layout(b, g, surgery, mask_axes):
    """Launch layout of a 2-D or 3-D operand: the grid as ``(n0, n1,
    n2)`` (a 2-D grid is ``(1, nx, ny)``), the first active axis, Γ per
    padded axis (one tensor three times when isotropic), and the surgery
    and mask bits on padded axes."""
    nd = b.ndim - 1
    first = 3 - nd
    n = (1,) * first + tuple(b.shape[1:])
    gs = [g] * 3 if g.ndim == nd else [g[0]] * first + [g[j] for j in range(nd)]
    lo = sum(1 << (first + j) for j, (k, _) in enumerate(surgery) if k == "neumann")
    up = sum(1 << (first + j) for j, (_, k) in enumerate(surgery) if k == "neumann")
    mask = sum(1 << (first + a) for a in set(mask_axes))
    return n, first, gs, lo, up, mask


def point_grid(shape) -> tuple:
    """The per-point kernel's launch grid for a ``(vdim, *nx)`` operand:
    ``(ceil(n2 / 128), n1, vdim * n0)`` (a 2-D grid has n0 = 1)."""
    n = (1,) * (4 - len(shape)) + tuple(shape[1:])
    return (-(-n[2] // _POINT_THREADS), n[1], shape[0] * n[0])


def _cuda_lib(name: str, t: torch.Tensor) -> ctypes.CDLL:
    """The library for a CUDA tensor, loaded before anything else: a CUDA
    tensor launches the kernel or raises, never the plain version."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return _lib()


def _launch(lib, name, mode, x, b, g, inv_dx2, surgery, avg, omega, mask_axes, march, chunk):
    """Launch one kernel of ``lib`` for ``diff_field`` (``mode`` _APPLY,
    ``x`` the operand, ``b`` unused: None) or ``diff_jacobi``: the march
    or the per-point kernel (``march`` None: ``uses_march``); raises on a
    grid beyond the chosen kernel's launch limits."""
    op = x if b is None else b
    check_inputs(name, x, op, g, inv_dx2, surgery, avg, mask_axes)
    n, first, gs, lo, up, mask = _layout(op, g, surgery, mask_axes)
    vdim = op.shape[0]
    march = uses_march(op.shape) if march is None else bool(march)
    if march:
        iso = g.ndim == op.ndim - 1
        resident = resident_blocks(lib, op.device.index, "pyapes_diff_jacobi_blocks_per_sm",
                                   op.dtype, mode, int(iso), int(march_full(op.shape, op.dtype)),
                                   _AVG[avg])
        grid, ci, _ = march_geometry((vdim, *n), resident, chunk, _VG_TILE[op.dtype],
                                     _VG_SETUP_PLANES)
        if n[1] * n[2] >= 2**31:
            raise ValueError(f"{name}: a plane of {tuple(op.shape)} exceeds 2^31 points")
        cw = copy_bytes(op, n[2], [t for t in (x, b) if t is not None] + gs)
    else:
        grid, ci, cw = point_grid(op.shape), 0, 0
    if max(grid[1:]) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: grid {tuple(op.shape)} exceeds the launch limits")
    out = torch.empty_like(op)
    inv = [1.0] * first + [float(v) for v in inv_dx2]
    ptrs = [t.data_ptr() for t in gs]
    with torch.cuda.device(op.device):
        stream = torch.cuda.current_stream(op.device).cuda_stream
        if mode == _APPLY:
            err = lib.pyapes_diff_field(
                _DTYPE_CODE[op.dtype], vdim, *n, first, x.data_ptr(), *ptrs, out.data_ptr(),
                *inv, lo, up, _AVG[avg], ci, cw, stream)
        else:
            err = lib.pyapes_diff_jacobi(
                _DTYPE_CODE[op.dtype], mode, vdim, *n, first,
                None if x is None else x.data_ptr(), b.data_ptr(), *ptrs, out.data_ptr(),
                *inv, float(omega), lo, up, mask, _AVG[avg], ci, cw, stream)
    cuda_build.check(lib, err, name)
    return out


def diff_field(x, g, inv_dx2, surgery, avg: str = "arithmetic", *, march=None,
               chunk=None) -> torch.Tensor:
    """``∂_j (Γ ∂_j x)``; ``x``: ``(vdim, *nx)``, ``g``: ``nx`` or ``(dim,
    *nx)`` of ``x``'s dtype. A CPU tensor goes to the plain
    ``apply_diff_field``; a CUDA tensor launches a kernel on the current
    stream (``march``: None the shape's choice, True the plane march, False
    the per-point kernel; ``chunk``: the march's planes per block), or
    raises."""
    if x.device.type == "cpu":
        check_inputs("diff_field", None, x, g, inv_dx2, surgery, avg)
        return apply_diff_field(x, g, inv_dx2, surgery, avg)
    lib = _cuda_lib("diff_field", x)
    out = _launch(lib, "diff_field", _APPLY, x, None, g, inv_dx2, surgery, avg, 0.0, (),
                  march, chunk)
    diff_field.launches += 1
    record_kernel("diff_field", out)
    return out


def diff_jacobi(x, b, g, inv_dx2, surgery, avg="arithmetic", omega=2.0 / 3.0,
                mask_axes=(0, 1, 2), mode="smooth", *, march=None, chunk=None) -> torch.Tensor:
    """One variable-Γ V-cycle pass (``mode`` "smooth", "smooth0" — ``x``
    not read, may be None — or "resid"; see ``apply_diff_jacobi``). CPU:
    the plain ``apply_diff_jacobi``; CUDA: a kernel (``march``, ``chunk``
    as in ``diff_field``), or raises."""
    if mode not in _MODES:
        raise ValueError(f"diff_jacobi: mode must be one of {tuple(_MODES)}, got {mode!r}")
    if x is None and mode != "smooth0":
        raise ValueError(f"diff_jacobi: mode {mode!r} needs x")
    x = None if mode == "smooth0" else x
    if b.device.type == "cpu":
        check_inputs("diff_jacobi", x, b, g, inv_dx2, surgery, avg, mask_axes)
        return apply_diff_jacobi(x, b, g, inv_dx2, surgery, avg, omega, mask_axes, mode)
    lib = _cuda_lib("diff_jacobi", b)
    out = _launch(lib, "diff_jacobi", _MODES[mode], x, b, g, inv_dx2, surgery, avg, omega,
                  mask_axes, march, chunk)
    diff_jacobi.launches += 1
    record_kernel("diff_jacobi", out)
    return out


diff_field.launches = 0
diff_jacobi.launches = 0
