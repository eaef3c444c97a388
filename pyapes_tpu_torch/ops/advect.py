"""Per-point advection kernels: the hand-written Hopper kernels of
``csrc/advect.cu`` (per-point) and ``csrc/advect_march.cu`` (plane march)
and their two wrappers (the port's counterpart of the varying-advection
pair of ``pyapes_tpu/ops/pallas_advect.py``).

* ``advect_pair``: the ``div_field`` term, ``fdm.div(u_field, phi)`` —
  one scalar ``(1, *nx)`` summed over the (axis, component) pairs.
  Replaces ``pallas_advect.py::pallas_advect_pair``.
* ``conv_component``: the ``conv_field`` term, ``fdm.conv(u, phi)`` —
  ``(u . grad) phi_i`` for every component. Replaces
  ``pallas_advect.py::pallas_conv_component``.

Both run all three limiters (central in either form, upwind, and QUICK,
which the TPU kernels left to their jnp path), and the surgery kinds
none / neumann / periodic.

What bounds them: ~20 flops per point and axis against the compulsory
traffic of 3 grids for the Div (read x and u, write out) and 2 + dim for
the Conv (x, one advector per axis, out): HBM-bound, like the other
stencils. One function, two hand-written kernels chosen by the shape and
the limiter alone (``uses_march``), never by a failure:

* the plane march (``csrc/advect_march.cu``; 3-D grids of at least
  ``MARCH_MIN_POINTS`` points per component whose every column tile lies
  inside them, central and upwind): ``ops/axis_stencil.py``'s march at
  radius 1. A block owns a 16 x 128 ``(j, k)`` column tile (8 x 128 in
  f64) and a chunk of planes of one output component along axis 0
  (``ops/march.py``); the operands read at a neighbour are staged with
  16-byte ``cp.async`` copies into a 4-slot ring two planes ahead (x on
  a ±1-row, ±16-byte window; the conservative central Div's advector
  beside it; a vector target's x[1] and x[2] each with its own axis'
  halo only), an advector read only at the point is read once with pair
  loads, x(p-1) and x(p) stay in registers; the base vectors live in
  registers (axis 0 per plane, axis 1 per row, axis 2 per column), the
  surgery is resolved per plane, row and column, the wrap by tables.
* the per-point kernel (``csrc/advect.cu``; 1-D, 2-D and small 3-D grids,
  QUICK): one thread per output point with the last axis along
  ``threadIdx.x`` (coalesced), the neighbour rows and planes of x and u
  re-read through L1/L2, the coefficients and the surgery built in
  registers from the 1-D base vectors.

Both wrap every neighbour index (torus) as ``torch.roll`` in the plain
versions, compute in ``promote(dtype, f32)`` with one rounding on store,
and apply the surgery of an axis in sequence, lower face first. A march
point is the per-point kernel's expression term for term, so the two
kernels give the same bits (a solve takes the same iterations whichever
kernel its shape takes), and chunk seams change no bits. The Div's
``vdim > 1`` pairs and the Conv's components are one launch each, not a
Python loop of launches; the TPU gate (3-D, last axis a multiple of 128)
is not carried over: 1-, 2- and 3-D grids of at least 3 nodes per axis
run.

Each wrapper launches a kernel for a CUDA tensor (or raises) and calls
the plain version of ``ops.stencil`` for a CPU tensor, whatever ``march``
and ``chunk`` say; ``<fn>.launches`` counts kernel launches (a Python
count: a launch captured into a CUDA graph counts at the warm-up and at
the capture, not at a replay).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pyapes_tpu_torch.ops import cuda_build
from pyapes_tpu_torch.ops.march import copy_bytes, march_geometry, resident_blocks
from pyapes_tpu_torch.ops.stencil import apply_conv_field, apply_div_field
from pyapes_tpu_torch.utils.debug import record_kernel

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_LIMITER = {"none": 0, "upwind": 1, "quick": 2}
_SIDE = {"none": 0, "neumann": 1, "periodic": 2}
_FORMS = ("conservative", "advective")
_MAX_GRID_YZ = 65535
# the march's (j, k) column tile per dtype (csrc/advect_march.cu av_tj() x
# AV_TK) and a block's fixed cost in planes (its prologue's two planes)
_TILE = {torch.bfloat16: (16, 128), torch.float32: (16, 128), torch.float64: (8, 128)}
_SETUP_PLANES = 2
# the march's operands (csrc/advect_march.cuh AdvMarchKind, AdvMarchForm)
_CONV, _DIV_S, _DIV_V = 0, 1, 2
_CENTRAL, _UPWIND, _CONSERVATIVE = 0, 1, 2
# the least points per component of a 3-D grid that the march takes, on
# grids whose every 16 x 128 tile lies inside them: else the per-point
# kernel (PERF.md §6, the level table of adv_level_times)
MARCH_MIN_POINTS = 128**3


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("advect")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pyapes_advect.argtypes = [I, I, ctypes.POINTER(P), ctypes.POINTER(I),
                                  ctypes.c_longlong, P, P]
    lib.pyapes_advect.restype = I
    lib.pyapes_advect_march.argtypes = [I] * 4 + [ctypes.POINTER(P), ctypes.POINTER(I)] + [I] * 3 \
        + [P, P]
    lib.pyapes_advect_march.restype = I
    lib.pyapes_advect_march_blocks_per_sm.argtypes = [I] * 4 + [ctypes.POINTER(I)]
    lib.pyapes_advect_march_blocks_per_sm.restype = I
    return lib


def uses_march(shape, limiter: str) -> bool:
    """The kernel a ``(vdim, *nx)`` target takes, from its shape and the
    limiter alone: the plane march for a 3-D grid of at least
    ``MARCH_MIN_POINTS`` points per component whose every 16 x 128 column
    tile lies inside it (``march_full``) and a limiter other than QUICK,
    else the per-point kernel (1-D, 2-D, small grids, tiles that overhang
    the grid, QUICK)."""
    nx = tuple(shape[1:])
    return (len(nx) == 3 and nx[0] * nx[1] * nx[2] >= MARCH_MIN_POINTS and march_full(shape)
            and limiter != "quick")


def march_full(shape, dtype: torch.dtype = torch.float32) -> bool:
    """Every march tile of ``dtype`` lies inside the grid of a ``(vdim,
    n0, n1, n2)`` operand (the march's ``FULL`` instance, compile-time
    window bounds)."""
    tj, tk = _TILE[dtype]
    return shape[-2] % tj == 0 and shape[-1] % tk == 0


def check_march(name, x, limiter, march) -> None:
    """Raise where ``march=True`` asks for the plane march on what it does
    not take: a 1-D or 2-D grid, or QUICK (on any device)."""
    if march and (x.ndim != 4 or limiter == "quick"):
        raise ValueError(f"{name}: the plane march takes 3-D grids, central or upwind, got "
                         f"{tuple(x.shape)} {limiter}")


def check_inputs(name, x, adv, base, limiter, surgery, form="conservative", march=False) -> None:
    """Raise on what the kernel does not take: ``x`` of a dtype other than
    bf16/f32/f64, not ``(vdim, *nx)`` with 1-3 mesh axes of >= 3 nodes, or
    not contiguous; ``adv`` of another dtype, device or grid, not
    contiguous, or without the components the term reads (Div: 1 or
    ``vdim``, and ``vdim`` 1 or >= dim; Conv: dim); base vectors not three
    contiguous 1-D tensors of the axis length in ``x``'s dtype and device;
    an unknown limiter, form or surgery kind; a grid beyond the launch
    limits."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (bf16, f32, f64)")
    nd = x.ndim - 1
    if not 1 <= nd <= 3:
        raise ValueError(f"{name}: x must be (vdim, *nx) with 1-3 mesh axes, got {tuple(x.shape)}")
    nx = tuple(x.shape[1:])
    if min(nx) < 3:
        raise ValueError(f"{name}: every axis needs >= 3 nodes, got {nx}")
    for t, what in ((x, "x"), (adv, "adv")):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name}: {what} must have x's dtype {x.dtype} and device "
                            f"{x.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if adv.ndim != x.ndim or tuple(adv.shape[1:]) != nx:
        raise ValueError(f"{name}: adv {tuple(adv.shape)} is not (components, *{nx})")
    vdim, ncomp = x.shape[0], adv.shape[0]
    if name == "conv_component":
        if ncomp != nd:
            raise ValueError(f"{name}: adv needs one component per mesh axis, got {ncomp}")
    elif ncomp not in (1, vdim) or not (vdim == 1 or vdim >= nd):
        raise ValueError(f"{name}: x with {vdim} and adv with {ncomp} components do not pair "
                         f"with {nd} mesh axes")
    if len(base) != nd or len(surgery) != nd:
        raise ValueError(f"{name}: base and surgery need {nd} axis entries")
    for a, cs in enumerate(base):
        if len(cs) != 3:
            raise ValueError(f"{name}: axis {a} base must be (ap0, ac0, am0)")
        for c in cs:
            if (c.ndim != 1 or c.shape[0] != nx[a] or c.dtype != x.dtype
                    or c.device != x.device or not c.is_contiguous()):
                raise ValueError(f"{name}: axis {a} base vectors must be contiguous 1-D "
                                 f"{x.dtype} of length {nx[a]} on {x.device}")
    if limiter not in _LIMITER:
        raise ValueError(f"{name}: limiter must be one of {tuple(_LIMITER)}, got {limiter!r}")
    if form not in _FORMS:
        raise ValueError(f"{name}: form must be one of {_FORMS}, got {form!r}")
    if any(k not in _SIDE for pair in surgery for k in pair):
        raise ValueError(f"{name}: surgery kinds must be {tuple(_SIDE)}, got {surgery}")
    if march:
        return
    n_mid = nx[-2] if nd >= 2 else 1
    n_slab = (vdim if name == "conv_component" else 1) * (nx[0] if nd == 3 else 1)
    if max(n_mid, n_slab) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: grid {tuple(x.shape)} exceeds the launch limits")


def _launch(name, x, adv, base, limiter, surgery, form, conv: bool, march, chunk) -> torch.Tensor:
    """Check, lay out on the padded 3 axes, launch the plane march or the
    per-point kernel (``march`` None: ``uses_march``, the shape and limiter
    alone; the wrappers have checked a True), ``chunk`` the march's planes
    per block; returns ``out``."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _lib()  # loaded first: a CUDA tensor never falls back to the plain version
    march = uses_march(x.shape, limiter) if march is None else bool(march)
    check_inputs(name, x, adv, base, limiter, surgery, form, march)
    nd = x.ndim - 1
    first = 3 - nd
    vol = x[0].numel()
    n = (1,) * first + tuple(x.shape[1:])
    xs, us = [x.data_ptr()] * 3, [adv.data_ptr()] * 3
    bases = [[base[0][k].data_ptr()] * 3 for k in range(3)]
    for j in range(nd):
        a = first + j
        if not conv and x.shape[0] > 1:
            xs[a] = x.data_ptr() + j * vol * x.element_size()
        if conv or adv.shape[0] > 1:
            us[a] = adv.data_ptr() + j * vol * adv.element_size()
        for k in range(3):
            bases[k][a] = base[j][k].data_ptr()
    kinds = [(0, 0)] * first + [(_SIDE[lo], _SIDE[up]) for lo, up in surgery]
    axes = sum(1 << (first + j) for j in range(nd))
    ints = (ctypes.c_int * 12)(*n, axes, *(k[0] for k in kinds), *(k[1] for k in kinds),
                               _LIMITER[limiter], int(form == "conservative"))
    ncomp = x.shape[0] if conv else 1
    out = torch.empty((ncomp, *x.shape[1:]), dtype=x.dtype, device=x.device)
    ptrs = (ctypes.c_void_p * 15)(*xs, *us, *bases[0], *bases[1], *bases[2])
    dtype = _DTYPE_CODE[x.dtype]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if march:
            kind = _CONV if conv else (_DIV_S if x.shape[0] == 1 else _DIV_V)
            fm = (_UPWIND if limiter == "upwind" else
                  _CONSERVATIVE if form == "conservative" and not conv else _CENTRAL)
            n0, n1, n2 = n
            full = int(march_full(x.shape, x.dtype))
            resident = resident_blocks(lib, x.device.index, "pyapes_advect_march_blocks_per_sm",
                                       x.dtype, kind, fm, full)
            grid, ci, _ = march_geometry((ncomp, n0, n1, n2), resident, chunk, _TILE[x.dtype],
                                         _SETUP_PLANES)
            if max(grid[1:]) > _MAX_GRID_YZ or n1 * n2 >= 2**31:
                raise ValueError(f"{name}: grid {tuple(x.shape)} exceeds the march's launch "
                                 "limits")
            # the operands staged per plane, and those read in pairs at the points
            u = [adv[a if adv.shape[0] > 1 else 0] for a in range(3)]  # axis a's advector
            cons = fm == _CONSERVATIVE
            if kind == _DIV_V:
                staged, points = [x[1], x[2]] + (u[1:] if cons else []), [x[0]] + u
            else:
                staged, points = list(x) + (u[:1] if cons else []), [] if cons else u
            size = x.element_size()
            pairs = int(n2 % 2 == 0 and all(t.data_ptr() % (2 * size) == 0 for t in points))
            err = lib.pyapes_advect_march(dtype, kind, fm, ncomp, ptrs, ints, pairs, ci,
                                          copy_bytes(x, n2, staged), out.data_ptr(), stream)
        else:
            err = lib.pyapes_advect(dtype, ncomp, ptrs, ints, vol if conv else 0,
                                    out.data_ptr(), stream)
    cuda_build.check(lib, err, name)
    return out


def advect_pair(x, adv, base, limiter: str, surgery, form: str = "conservative", *,
                march=None, chunk=None) -> torch.Tensor:
    """The Div of a per-point advecting field, ``(1, *nx)`` (arguments as
    ``ops.stencil.apply_div_field``).

    ``march``: the kernel of a CUDA tensor: None the shape and limiter's
    choice (``uses_march``), True the plane march (3-D, central or
    upwind), False the per-point kernel; ``chunk``: the march's planes per
    block (None: ``march_geometry``'s). A CPU tensor goes to the plain
    ``apply_div_field``; a CUDA tensor launches a kernel on the current
    stream, or raises. ``march=True`` on a 1-D/2-D grid or with QUICK
    raises on any device."""
    check_march("advect_pair", x, limiter, march)
    if x.device.type == "cpu":
        check_inputs("advect_pair", x, adv, base, limiter, surgery, form)
        return apply_div_field(x, adv, base, limiter, surgery, form)
    out = _launch("advect_pair", x, adv, base, limiter, surgery, form, False, march, chunk)
    advect_pair.launches += 1
    record_kernel("advect_pair", out)
    return out


def conv_component(x, adv, base, limiter: str, surgery, *, march=None,
                   chunk=None) -> torch.Tensor:
    """``(u . grad) phi_i`` for every component, ``(vdim, *nx)`` (arguments
    as ``ops.stencil.apply_conv_field``; ``march``, ``chunk`` as in
    ``advect_pair``). A CPU tensor goes to the plain ``apply_conv_field``;
    a CUDA tensor launches a kernel on the current stream, or raises."""
    check_march("conv_component", x, limiter, march)
    if x.device.type == "cpu":
        check_inputs("conv_component", x, adv, base, limiter, surgery, "advective")
        return apply_conv_field(x, adv, base, limiter, surgery)
    out = _launch("conv_component", x, adv, base, limiter, surgery, "advective", True, march,
                  chunk)
    conv_component.launches += 1
    record_kernel("conv_component", out)
    return out


advect_pair.launches = 0
conv_component.launches = 0
