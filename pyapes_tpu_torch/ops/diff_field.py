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

What bounds them: ~30 flops per point against 3 grids of compulsory
traffic for ``diff_field`` (read x and Γ, write out) and 4 for
``diff_jacobi`` (x, Γ, b, out) — HBM-bound, like the other stencils. The
design is the single Jacobi sweep's: one thread per point, the last axis
along ``threadIdx.x`` (coalesced), neighbour rows and planes of x and Γ
re-read through L1/L2, wrap, surgery and mask as index arithmetic, math in
``promote(dtype, f32)`` with one rounding on store. The TPU kernels' gates
(lane-aligned last axis, VMEM slab sizes) are not carried over: every 2-D
or 3-D grid of at least 3 nodes per axis runs, and stacked (anisotropic) Γ
too, as one Γ pointer per axis.

Each wrapper launches its kernel for a CUDA tensor (or raises) and calls
the plain version of ``ops.stencil`` for a CPU tensor; ``<fn>.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pyapes_tpu_torch.ops import cuda_build
from pyapes_tpu_torch.ops.stencil import apply_diff_field, apply_diff_jacobi

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_MODES = {"smooth": 0, "smooth0": 1, "resid": 2}
_AVG = {"arithmetic": 0, "harmonic": 1}
_KINDS = ("none", "neumann")
_MAX_GRID_YZ = 65535


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("diff_field")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.pyapes_diff_field.argtypes = [I] * 6 + [P] * 5 + [D] * 3 + [I] * 3 + [P]
    lib.pyapes_diff_field.restype = I
    lib.pyapes_diff_jacobi.argtypes = [I] * 7 + [P] * 6 + [D] * 4 + [I] * 4 + [P]
    lib.pyapes_diff_jacobi.restype = I
    return lib


def check_inputs(name, x, b, g, inv_dx2, surgery, avg, mask_axes=()) -> None:
    """Raise on what the kernels do not take: ``b`` (the operand that
    fixes shape, dtype and device) of a dtype other than bf16/f32/f64, of
    a shape other than ``(vdim, *nx)`` with a 2-D or 3-D grid of >= 3
    nodes per axis, or not contiguous; ``x`` (when given) and ``g`` of
    another dtype or device, or not contiguous; ``x`` of another shape;
    ``g`` not ``nx`` (isotropic) or ``(dim, *nx)`` (stacked); a wrong
    ``inv_dx2``, ``surgery`` (kinds "none"/"neumann"), ``avg`` or
    ``mask_axes``; or a grid beyond the launch limits."""
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
    n0 = nx[0] if nd == 3 else 1
    if max(nx[-2], b.shape[0] * n0) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: grid {tuple(b.shape)} exceeds the launch limits")


def _layout(b, g, surgery, mask_axes):
    """Launch geometry of a 2-D or 3-D operand: the grid as ``(n0, n1,
    n2)`` (a 2-D grid is ``(1, nx, ny)``), the first active axis, one Γ
    pointer per padded axis, and the surgery and mask bits on padded
    axes."""
    nd = b.ndim - 1
    first = 3 - nd
    n = (1,) * first + tuple(b.shape[1:])
    if g.ndim == nd:
        ptrs = [g.data_ptr()] * 3
    else:
        ptrs = [g[0].data_ptr()] * first + [g[j].data_ptr() for j in range(nd)]
    lo = sum(1 << (first + j) for j, (k, _) in enumerate(surgery) if k == "neumann")
    up = sum(1 << (first + j) for j, (_, k) in enumerate(surgery) if k == "neumann")
    mask = sum(1 << (first + a) for a in set(mask_axes))
    return n, first, ptrs, lo, up, mask


def _inv3(inv_dx2, first) -> list[float]:
    return [1.0] * first + [float(v) for v in inv_dx2]


def _cuda_lib(name: str, t: torch.Tensor) -> ctypes.CDLL:
    """The library for a CUDA tensor, loaded before anything else: a CUDA
    tensor launches the kernel or raises, never the plain version."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return _lib()


def diff_field(x, g, inv_dx2, surgery, avg: str = "arithmetic") -> torch.Tensor:
    """``∂_j (Γ ∂_j x)``; ``x``: ``(vdim, *nx)``, ``g``: ``nx`` or ``(dim,
    *nx)`` of ``x``'s dtype. A CPU tensor goes to the plain
    ``apply_diff_field``; a CUDA tensor launches the kernel on the current
    stream, or raises."""
    if x.device.type == "cpu":
        check_inputs("diff_field", None, x, g, inv_dx2, surgery, avg)
        return apply_diff_field(x, g, inv_dx2, surgery, avg)
    lib = _cuda_lib("diff_field", x)
    check_inputs("diff_field", None, x, g, inv_dx2, surgery, avg)
    n, first, ptrs, lo, up, _ = _layout(x, g, surgery, ())
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.pyapes_diff_field(
            _DTYPE_CODE[x.dtype], x.shape[0], *n, first, x.data_ptr(), *ptrs, out.data_ptr(),
            *_inv3(inv_dx2, first), lo, up, _AVG[avg],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    cuda_build.check(lib, err, "diff_field")
    diff_field.launches += 1
    return out


def diff_jacobi(x, b, g, inv_dx2, surgery, avg="arithmetic", omega=2.0 / 3.0,
                mask_axes=(0, 1, 2), mode="smooth") -> torch.Tensor:
    """One variable-Γ V-cycle pass (``mode`` "smooth", "smooth0" — ``x``
    not read, may be None — or "resid"; see ``apply_diff_jacobi``). CPU:
    the plain ``apply_diff_jacobi``; CUDA: the kernel, or raises."""
    if mode not in _MODES:
        raise ValueError(f"diff_jacobi: mode must be one of {tuple(_MODES)}, got {mode!r}")
    if x is None and mode != "smooth0":
        raise ValueError(f"diff_jacobi: mode {mode!r} needs x")
    x = None if mode == "smooth0" else x
    if b.device.type == "cpu":
        check_inputs("diff_jacobi", x, b, g, inv_dx2, surgery, avg, mask_axes)
        return apply_diff_jacobi(x, b, g, inv_dx2, surgery, avg, omega, mask_axes, mode)
    lib = _cuda_lib("diff_jacobi", b)
    check_inputs("diff_jacobi", x, b, g, inv_dx2, surgery, avg, mask_axes)
    n, first, ptrs, lo, up, mask = _layout(b, g, surgery, mask_axes)
    out = torch.empty_like(b)
    with torch.cuda.device(b.device):
        err = lib.pyapes_diff_jacobi(
            _DTYPE_CODE[b.dtype], _MODES[mode], b.shape[0], *n, first,
            None if x is None else x.data_ptr(), b.data_ptr(), *ptrs, out.data_ptr(),
            *_inv3(inv_dx2, first), float(omega), lo, up, mask, _AVG[avg],
            torch.cuda.current_stream(b.device).cuda_stream,
        )
    cuda_build.check(lib, err, "diff_jacobi")
    diff_jacobi.launches += 1
    return out


diff_field.launches = 0
diff_jacobi.launches = 0
