"""Per-point advection kernels: the hand-written Hopper kernel of
``csrc/advect.cu`` and its two wrappers (the port's counterpart of the
varying-advection pair of ``pyapes_tpu/ops/pallas_advect.py``).

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
stencils. The design is the variable-Γ kernels': one thread per output
point with the last axis along ``threadIdx.x`` (coalesced), the
neighbour rows and planes of x and u re-read through L1/L2, the
coefficients and the surgery built in registers from the 1-D base
vectors, every neighbour index wrapped (torus) as ``torch.roll`` in the
plain versions, math in ``promote(dtype, f32)`` with one rounding on
store. The Div's ``vdim > 1`` pairs and the Conv's components are one
launch each, not a Python loop of launches; the TPU gate (3-D, last axis
a multiple of 128) is not carried over: 1-, 2- and 3-D grids of at least 3
nodes per axis run.

Each wrapper launches the kernel for a CUDA tensor (or raises) and calls
the plain version of ``ops.stencil`` for a CPU tensor; ``<fn>.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pyapes_tpu_torch.ops import cuda_build
from pyapes_tpu_torch.ops.stencil import apply_conv_field, apply_div_field

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_LIMITER = {"none": 0, "upwind": 1, "quick": 2}
_SIDE = {"none": 0, "neumann": 1, "periodic": 2}
_FORMS = ("conservative", "advective")
_MAX_GRID_YZ = 65535


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("advect")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pyapes_advect.argtypes = [I, I, ctypes.POINTER(P), ctypes.POINTER(I),
                                  ctypes.c_longlong, P, P]
    lib.pyapes_advect.restype = I
    return lib


def check_inputs(name, x, adv, base, limiter, surgery, form="conservative") -> None:
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
    n_mid = nx[-2] if nd >= 2 else 1
    n_slab = (vdim if name == "conv_component" else 1) * (nx[0] if nd == 3 else 1)
    if max(n_mid, n_slab) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: grid {tuple(x.shape)} exceeds the launch limits")


def _launch(name, x, adv, base, limiter, surgery, form, conv: bool) -> torch.Tensor:
    """Check, lay out on the padded 3 axes, launch; returns ``out``."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _lib()  # loaded first: a CUDA tensor never falls back to the plain version
    check_inputs(name, x, adv, base, limiter, surgery, form)
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
    ints = [*n, axes, *(k[0] for k in kinds), *(k[1] for k in kinds), _LIMITER[limiter],
            int(form == "conservative")]
    ncomp = x.shape[0] if conv else 1
    out = torch.empty((ncomp, *x.shape[1:]), dtype=x.dtype, device=x.device)
    ptrs = (ctypes.c_void_p * 15)(*xs, *us, *bases[0], *bases[1], *bases[2])
    with torch.cuda.device(x.device):
        err = lib.pyapes_advect(
            _DTYPE_CODE[x.dtype], ncomp, ptrs, (ctypes.c_int * 12)(*ints),
            vol if conv else 0, out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        )
    cuda_build.check(lib, err, name)
    return out


def advect_pair(x, adv, base, limiter: str, surgery, form: str = "conservative") -> torch.Tensor:
    """The Div of a per-point advecting field, ``(1, *nx)`` (arguments as
    ``ops.stencil.apply_div_field``). A CPU tensor goes to the plain
    ``apply_div_field``; a CUDA tensor launches the kernel on the current
    stream, or raises."""
    if x.device.type == "cpu":
        check_inputs("advect_pair", x, adv, base, limiter, surgery, form)
        return apply_div_field(x, adv, base, limiter, surgery, form)
    out = _launch("advect_pair", x, adv, base, limiter, surgery, form, conv=False)
    advect_pair.launches += 1
    return out


def conv_component(x, adv, base, limiter: str, surgery) -> torch.Tensor:
    """``(u . grad) phi_i`` for every component, ``(vdim, *nx)`` (arguments
    as ``ops.stencil.apply_conv_field``). A CPU tensor goes to the plain
    ``apply_conv_field``; a CUDA tensor launches the kernel on the current
    stream, or raises."""
    if x.device.type == "cpu":
        check_inputs("conv_component", x, adv, base, limiter, surgery, "advective")
        return apply_conv_field(x, adv, base, limiter, surgery)
    out = _launch("conv_component", x, adv, base, limiter, surgery, "advective", conv=True)
    conv_component.launches += 1
    return out


advect_pair.launches = 0
conv_component.launches = 0
