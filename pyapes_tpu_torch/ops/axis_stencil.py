"""Per-axis 3- and 5-point stencil apply, and the apply fused with the CG
alpha-dot: the hand-written Hopper kernels and their wrappers (the port's
counterpart of the axis-stencil kernels of ``pyapes_tpu/ops/pallas_stencil*.py``).

``axis_stencil`` replaces three Pallas TPU kernels that compute one
function — ``pallas_stencil.py::pallas_axis_stencil`` (2-D and 3-D tiled),
``pallas_stencil_db.py::pallas_axis_stencil_db`` (3-D, double-buffered
ghost DMAs) and ``pallas_stencil_v3.py::pallas_axis_stencil_v3`` (3-D,
slab-resident) — with the kernels below (radius 1), for any grid of at
least 3 nodes per axis: the TPU's (8, 128) tiling gates,
pad-and-crop and in-register row selection do not apply on the card.
``axis_stencil_dot`` replaces ``pallas_stencil_db.py::pallas_axis_stencil_dot``
and ``pallas_stencil_v3.py::pallas_axis_stencil_dot_v3`` (3-D): the same
apply plus ``sum(x * A x)`` per component, so CG never re-reads ``d`` and
``A d`` for its alpha-dot. ``axis_stencil5`` replaces
``pallas_stencil_v3.py::pallas_axis_stencil_v5``: the apply with 5-point
(QUICK, offsets +-2) axes mixed with 3-point ones, 1-3-D: the same
kernels at radius 2; ``axis_stencil`` hands a 5-point equation to it.
``axis_stencil_ext`` replaces
``pallas_stencil_v3.py::pallas_axis_stencil_ext``: the 3-D apply on one
block of a domain decomposition, extended by one ghost row per side of
each cut axis (``parallel/halo.py`` fills the ghosts), with no wrap on
an extended axis, writing through output strides into the block's view
of the global result (no stitching pass).

What bounds them: the apply does 2R+1 multiply-adds per axis and point
(R = 1: 3-point, R = 2: 5-point) against 2-4 bytes each way (bf16/f32) of
compulsory traffic (read x, write out), far below the card's FLOP-to-byte
balance — they are HBM-bound, and the floor is two grids of device-memory
traffic per apply. ``axis_stencil`` and ``axis_stencil5`` are one function
at two radii, computed by hand-written kernels chosen by the shape alone
(``uses_march``, ``uses_row_march``), never by a failure:

* the plane march (``csrc/axis_march.cu``, 3-D grids of at least
  ``MARCH_MIN_POINTS`` points per component whose every column tile lies
  inside them), one template for both radii:
  ``ops/jacobi.py``'s single-sweep design with a reach of R. A
  block owns a 16 x 128 ``(j, k)`` column tile and a chunk of planes of
  one component along axis 0 (``ops/march.py``); x is staged with
  16-byte ``cp.async`` copies on a ±R-row, ±16-byte-column window into a
  ring of 2R+2 shared-memory slots, two steps ahead; a thread keeps its
  points' axis-0 neighbours x(p-R) .. x(p+R-1) in registers, so x is read
  from HBM about once. Coefficients are never read per point: axis 0's
  per plane (uniform), axis 1's per row and axis 2's per column in
  registers. Wrap tables once per block, no ``%`` per point; a 3-point
  axis of a 5-point equation skips its ±2 taps on a block-uniform bit; a
  ``FULL`` instance for grids whose every tile lies inside them.
* the row march (``csrc/axis_march2d.cu``, the radius-1 apply on 2-D
  grids of at least ``ROW_MIN_POINTS`` points per component): a thread
  owns 16 bytes of columns (one column where a row is no multiple of 16
  bytes) of a chunk of 1, 2, 4 or 8 rows (``row_geometry``: the longest
  that still gives every SM a block), loads its rows, the halo rows and
  columns and its coefficients all at once and marches down the chunk
  with x(i-1), x(i), x(i+1) in registers. At these grids (0.1-4 MB, in
  L2) a call is latency, which this design cuts: at 512 x 1024 f32 the
  device time falls from the per-point kernel's 4.7 µs to 3.2 (PERF.md §6).
* the per-point kernels (``csrc/axis_stencil.cu``; 1-D, smaller 2-D and
  small 3-D grids, where a launch is latency): one thread per output point
  with the last axis along ``threadIdx.x``; the ±1 (±2) rows and planes
  are re-reads that consecutive blocks find in L1/L2.

Both sum axis 0, 1, 2 in the plain version's order in ``promote(dtype,
f32)`` (bf16 is loaded, widened to f32 and rounded once on store) and wrap
every neighbour as ``torch.roll`` does. A march point is the per-point
kernel's arithmetic (the plane march: its expression term for term; the
row march: its sm_90a contraction written out in round-to-nearest
intrinsics), so the kernels give the same bits (a solve takes the same
iterations whichever kernel its shapes take), and chunk seams change no
bits.

The alpha-dot and the halo-extended apply are two more instances of the
radius-1 march, with the same choice between it and their per-point
kernels (``csrc/axis_stencil.cu``). ``axis_stencil_dot``'s march adds
``x * A x`` (``A x`` unrounded) over a thread's points and planes in a
register and reduces the block (warp shuffles, then its warps in order)
into one partial per block; the per-point kernel one partial per
128-thread block. The wrapper sums the partials with ``torch.sum`` in a
fixed order: no atomics, so a solve's ``itr`` is the same every run (the
dot's bits follow the kernel and the chunk). ``axis_stencil_ext``'s march
stages x from the extended block (the ghost planes of an extended axis 0
in place of the wrap, the ghost rows of an extended axis 1 in the
window's row table) and stores through the output's strides, in pairs;
it takes the blocks whose unextended shape ``uses_march`` takes and whose
output view a pair store can use (``uses_march_ext``).

Each wrapper launches a kernel for a CUDA tensor (or raises) and calls
the plain version of ``ops.stencil`` for a CPU tensor; ``<fn>.launches``
counts kernel launches (``axis_stencil.row_launches`` those of the row
march among them; a Python count: a launch captured into a CUDA graph
counts at the warm-up and at the capture, not at a replay). ``axis_stencil``, ``axis_stencil5`` and
``axis_stencil_dot`` launch through a launch plan (``_plan``, ``_Plan``):
built and checked once per coefficient tuple (by identity, the tuple held
by its plan), shape, dtype and device, kept in an LRU of ``_PLANS_MAX``,
it holds the kernel's choice, its geometry and its arguments laid out as
the C entry ``pyapes_axis_plan_launch`` reads them (``AxisPlan``), so a
call passes only x, out, the dot's partials and the current stream (never
cached: a graph capture launches on its own). Every wrapper takes
``march=True``/``False`` (force the march (a 3-D grid's plane march, a 2-D
grid's row march at radius 1) or the per-point kernel; True on another
grid raises) and ``chunk=`` (the plane march's planes per block, the row
march's rows per thread); tests and ``chip_smoke.py`` pin both with them.
"""
from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict

import torch

from pyapes_tpu_torch.ops import cuda_build
from pyapes_tpu_torch.ops.march import copy_bytes, march_geometry, resident_blocks
from pyapes_tpu_torch.ops.stencil import (
    apply_axis_stencil,
    apply_axis_stencil_dot,
    apply_axis_stencil_ext,
)
from pyapes_tpu_torch.utils.debug import record_kernel

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_MAX_GRID_YZ = 65535  # CUDA limit on gridDim.y / gridDim.z
_THREADS = 128  # threads per block of the per-point kernels (csrc/axis_stencil.cu)
# the march's (j, k) column tile (csrc/axis_march.cu AM_TJ x AM_TK), and a
# block's fixed cost in planes by radius (its prologue's 2R planes)
_TILE = (16, 128)
_SETUP_PLANES = {1: 2, 2: 4}
# the march's instances (pyapes_axis_march_blocks_per_sm's kind)
_APPLY, _DOT, _EXT = 0, 1, 2
# the least points per component of a 3-D grid that the march takes, on
# grids whose every tile lies inside them: else the per-point kernel. On
# the device, back to back, the march is the faster from 128^3 up and the
# slower at 64^3 (f32) and below, at both radii; at 129^3 (tiles 45%
# filled) it is the slower (PERF.md §6)
MARCH_MIN_POINTS = 128**3
# the least points per component of a 2-D grid that the row march takes:
# else the per-point kernel. On the device, back to back, the row march is
# the faster from 256 x 512 f32 (2.70 against 2.83 µs) and 1761 x 329 f64
# up, the slower at 257^2 f32, 441 x 83 f64 and below, where a call is the
# launch and one round of loads and the per-point kernel's one point per
# thread has the shorter path (PERF.md §6, PR 20)
ROW_MIN_POINTS = 2**17
# the row march (csrc/axis_march2d.cu): threads per block, the rows per
# thread it is built for (most first), and the blocks per SM that a chunk
# must leave the grid (the longest such chunk is taken)
_ROW_THREADS = 128
_ROW_CHUNKS = (8, 4, 2, 1)
_ROW_BLOCKS_PER_SM = 1
# a launch plan's kernel (csrc/axis_stencil.cu AxisPlan::kind)
(_PLAN_POINT, _PLAN_POINT5, _PLAN_POINT_DOT, _PLAN_MARCH, _PLAN_MARCH_DOT,
 _PLAN_ROW) = range(6)
# the launch plans kept, least recently used first out
_PLANS_MAX = 256


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("axis_stencil")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pyapes_axis_plan_launch.argtypes = [P] * 5
    lib.pyapes_axis_plan_launch.restype = I
    lib.pyapes_axis_stencil_ext.argtypes = [I] * 7 + [P, P, L, L, L, ctypes.POINTER(P), P]
    lib.pyapes_axis_stencil_ext.restype = I
    lib.pyapes_axis_march_blocks_per_sm.argtypes = [I] * 4 + [ctypes.POINTER(I)]
    lib.pyapes_axis_march_blocks_per_sm.restype = I
    lib.pyapes_axis_march_ext.argtypes = ([I] * 7 + [P, P, L, L, L, I, ctypes.POINTER(P)]
                                          + [I, I, P])
    lib.pyapes_axis_march_ext.restype = I
    return lib


def uses_march(shape) -> bool:
    """The kernel a ``(vdim, *nx)`` operand takes, from its shape alone:
    the plane march for a 3-D grid of at least ``MARCH_MIN_POINTS`` points
    per component whose every column tile lies inside it (``march_full``),
    else the per-point kernel (1-D, 2-D, small grids, tiles that overhang
    the grid); on a 2-D grid the radius-1 apply takes the row march
    (``uses_row_march``)."""
    nx = tuple(shape[1:])
    return len(nx) == 3 and nx[0] * nx[1] * nx[2] >= MARCH_MIN_POINTS and march_full(shape)


def uses_row_march(shape) -> bool:
    """Whether the radius-1 apply of a ``(vdim, *nx)`` operand takes the
    row march, from its shape alone: a 2-D grid of at least
    ``ROW_MIN_POINTS`` points per component (else the per-point kernel)."""
    return len(shape) == 3 and shape[1] * shape[2] >= ROW_MIN_POINTS


def uses_march_ext(shape, out=None) -> bool:
    """The kernel the halo-extended apply of an unextended block ``shape``
    ``(vdim, n0, n1, n2)`` takes, from the shape and the output view
    alone: the plane march where ``uses_march(shape)`` holds and ``out``
    (None: a new contiguous tensor) takes pair stores (``pair_stores``),
    else the per-point kernel."""
    return uses_march(shape) and (out is None or pair_stores(out))


def pair_stores(out: torch.Tensor) -> bool:
    """Whether the march can store pairs into ``out``: its base address
    and its three leading strides even in elements."""
    return (out.data_ptr() % (2 * out.element_size()) == 0
            and all(st % 2 == 0 for st in out.stride()[:3]))


def march_full(shape) -> bool:
    """Every march tile lies inside the grid of a ``(vdim, n0, n1, n2)``
    operand (the march's ``FULL`` instance, compile-time window bounds)."""
    return shape[-2] % _TILE[0] == 0 and shape[-1] % _TILE[1] == 0


def row_geometry(shape, size: int, sms: int, chunk=None):
    """Launch geometry of the row march on a ``(vdim, n0, n1)`` grid of
    ``size``-byte elements: ``(chunk, columns, blocks)``. A thread owns
    ``columns`` consecutive columns (16 bytes of them where a row is a
    multiple of 16 bytes, the operands' addresses allowing; else one) of
    ``chunk`` consecutive rows of one component; thread ``t`` of the grid
    takes column group ``t % G`` (``G = n1 / columns``), row chunk ``(t //
    G) % ceil(n0 / chunk)`` and component ``t // (G ceil(n0 / chunk))``, in
    blocks of ``_ROW_THREADS``. ``chunk`` (rows per thread, one of
    ``_ROW_CHUNKS``): when None, the longest whose grid has at least
    ``_ROW_BLOCKS_PER_SM`` blocks per SM of a card of ``sms`` SMs (else 1);
    given, the longest not above it."""
    vdim, n0, n1 = shape
    columns = 16 // size if n1 * size % 16 == 0 else 1

    def blocks(ci):
        return -(-vdim * -(-n0 // ci) * (n1 // columns) // _ROW_THREADS)

    if chunk is None:
        ci = next((c for c in _ROW_CHUNKS if blocks(c) >= _ROW_BLOCKS_PER_SM * sms), 1)
    else:
        ci = next((c for c in _ROW_CHUNKS if c <= int(chunk)), 1)
    return ci, columns, blocks(ci)


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_inputs(coeffs, x: torch.Tensor, points=(3, 5), march=False) -> None:
    """Raise on what the kernels do not take: dtype other than
    bf16/f32/f64, 1-3 mesh axes, a non-contiguous ``x``, an axis entry of
    other than 3 or 5 vectors, a 5-point axis where ``points`` is ``(3,)``
    (the alpha-dot kernel: CG operators are 3-point), coefficient vectors
    of the wrong length, dtype, device or layout, an axis with fewer than 3
    nodes, or a grid beyond the per-point kernels' launch limits (with
    ``march``: the march's, which the plan checks on its grid)."""
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
        if len(cs) not in (3, 5):
            raise ValueError(f"axis_stencil: axis {a} has {len(cs)} coefficient vectors (3 or 5)")
        if len(cs) not in points:
            raise NotImplementedError(f"axis_stencil: axis {a} is 5-point; this kernel takes "
                                      "3-point axes only")
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
    if march:
        return
    n_mid = x.shape[-2] if ndim >= 2 else 1
    n_slab = x.shape[0] * (x.shape[1] if ndim == 3 else 1)
    if n_mid > _MAX_GRID_YZ or n_slab > _MAX_GRID_YZ:
        raise ValueError(f"axis_stencil: grid {tuple(x.shape)} exceeds the launch limits")


def _march_geometry(name, lib, x, shape, kind, chunk, radius=1):
    """Launch geometry of the march instance ``kind`` of ``radius`` on the
    ``(vdim, n0, n1, n2)`` output ``shape`` from the input ``x``: ``(chunk,
    partials)``, or raises beyond its launch limits (a plane of ``x`` must
    fit an int)."""
    resident = resident_blocks(lib, x.device.index, "pyapes_axis_march_blocks_per_sm", x.dtype,
                               radius, int(march_full(shape)), kind)
    grid, ci, n_partial = march_geometry(shape, resident, chunk, _TILE, _SETUP_PLANES[radius])
    if max(grid[1:]) > _MAX_GRID_YZ or x.shape[-2] * x.shape[-1] >= 2**31:
        raise ValueError(f"{name}: grid {tuple(shape)} exceeds the march's launch limits")
    return ci, n_partial


class _PlanArgs(ctypes.Structure):
    """``AxisPlan`` of ``csrc/axis_stencil.cu``, field for field."""
    _fields_ = [("coeffs", ctypes.c_void_p * 15), ("kind", ctypes.c_int),
                ("dtype", ctypes.c_int), ("ndim", ctypes.c_int), ("vdim", ctypes.c_int),
                ("n", ctypes.c_int * 3), ("radius", ctypes.c_int), ("five", ctypes.c_int),
                ("ci", ctypes.c_int), ("cw", ctypes.c_int)]


class _Plan:
    """The launch of one operator on one kind of operand: ``coeffs`` (held,
    so that its identity, the plan's key, cannot name another tuple while
    the plan lives) applied to a contiguous ``x`` of one shape, dtype and
    device, through ``wrapper`` (``axis_stencil``, which hands a 5-point
    equation to ``axis_stencil5``, or ``axis_stencil_dot``; the one whose
    ``launches`` a call counts). Built once: the inputs
    checked (``check_inputs``, the launch limits), the kernel chosen
    (``march``: None the shape's choice, True the march, False the
    per-point kernel) with its geometry (``chunk``: the plane march's planes
    per block, the row march's rows per thread), and its arguments laid out
    in ``args`` (``AxisPlan``).
    A call passes x, out, the dot's partials and the current stream."""

    __slots__ = ("coeffs", "wrapper", "name", "lib", "entry", "index", "args", "addr", "partial",
                 "kernel", "row")

    def __init__(self, wrapper, coeffs, x: torch.Tensor, march, chunk):
        if wrapper is axis_stencil and any(len(cs) == 5 for cs in coeffs):
            wrapper = axis_stencil5  # a 5-point equation
        self.coeffs, self.wrapper, self.name = coeffs, wrapper, wrapper.__name__
        self.lib = lib = _lib()
        self.entry = lib.pyapes_axis_plan_launch
        self.index = x.device.index
        dot = wrapper is axis_stencil_dot
        radius = 2 if wrapper is axis_stencil5 else 1
        if march is None:
            kernel = ("plane" if uses_march(x.shape) else
                      "row" if radius == 1 and not dot and uses_row_march(x.shape) else "point")
        elif not march:
            kernel = "point"
        elif x.ndim == 4:
            kernel = "plane"
        elif x.ndim == 3 and radius == 1 and not dot:
            kernel = "row"
        else:
            raise ValueError(f"{self.name}: the plane march takes 3-D grids (the row march the "
                             f"2-D grids of axis_stencil), got {tuple(x.shape)}")
        check_inputs(coeffs, x, (3,) if radius == 1 else (3, 5), kernel != "point")
        self.kernel, self.row = kernel, kernel == "row"
        vdim, *n = x.shape
        a = self.args = _PlanArgs()
        a.dtype, a.ndim, a.vdim, a.radius = _DTYPE_CODE[x.dtype], len(n), vdim, radius
        a.n[:] = n + [1] * (3 - len(n))
        a.cw = copy_bytes(x, n[-1], [])  # the row's; the launch narrows it to x's address
        self.partial = None
        if kernel == "plane":
            a.kind = _PLAN_MARCH_DOT if dot else _PLAN_MARCH
            a.ci, n_partial = _march_geometry(self.name, lib, x, x.shape, _DOT if dot else _APPLY,
                                              chunk, radius)
            a.five = sum(1 << i for i, cs in enumerate(coeffs) if len(cs) == 5)
            width = 5
        elif kernel == "row":
            a.kind, width = _PLAN_ROW, 3
            a.ci, _, blocks = row_geometry(x.shape, x.element_size(), _sm_count(self.index),
                                           chunk)
            if blocks * _ROW_THREADS >= 2**31:
                raise ValueError(f"{self.name}: grid {tuple(x.shape)} exceeds the row march's "
                                 "launch limits")
        else:
            a.kind = _PLAN_POINT_DOT if dot else _PLAN_POINT5 if radius == 2 else _PLAN_POINT
            width = 5 if radius == 2 else 3
            n_partial = n[0] * n[1] * -(-n[2] // _THREADS) if dot else 0
        if dot:
            self.partial = ((vdim, n_partial), torch.promote_types(x.dtype, torch.float32))
        ptrs = []
        for cs in coeffs:
            p = [c.data_ptr() for c in cs]
            ptrs += [None, *p, None] if width == 5 and len(cs) == 3 else p
        a.coeffs[:] = ptrs + [None] * (15 - len(ptrs))
        self.addr = ctypes.addressof(a)

    def __call__(self, x: torch.Tensor, out: torch.Tensor, partial=None) -> None:
        """Launch on x's device's current stream (captured, inside a CUDA
        graph capture)."""
        if _current_device() == self.index:
            err = self.entry(self.addr, x.data_ptr(), out.data_ptr(), partial,
                             _current_stream(self.index))
        else:
            with torch.cuda.device(self.index):
                err = self.entry(self.addr, x.data_ptr(), out.data_ptr(), partial,
                                 _current_stream(self.index))
        if err:
            cuda_build.check(self.lib, err, self.name)


_PLANS: OrderedDict = OrderedDict()


def _current_device() -> int:
    """The current CUDA device (CUDA is initialized: x lies on the card)."""
    return torch._C._cuda_getDevice()


def _current_stream(index: int) -> int:
    """The raw handle of the current stream of device ``index``."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream


def _frozen(coeffs) -> bool:
    """Whether ``coeffs`` is a tuple of tuples: its identity then names its
    tensors for as long as it lives (a list may be refilled)."""
    return type(coeffs) is tuple and all(type(cs) is tuple for cs in coeffs)


def _plan(wrapper, coeffs, x: torch.Tensor, dev: torch.device, march, chunk) -> _Plan:
    """The launch plan of ``wrapper`` for ``coeffs`` on ``x``: built and
    checked at the first call of a coefficient tuple (by identity) on a
    shape, dtype and device with these ``march``/``chunk``, then kept
    (``_PLANS``, at most ``_PLANS_MAX``, least recently used out); a list
    of coefficients is planned on every call. ``dev``: ``x.device``.
    Raises what the kernels do not take."""
    key = (wrapper, id(coeffs), x.shape, x.dtype, dev, march, chunk)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _Plan(wrapper, coeffs, x, march, chunk)
        if _frozen(coeffs):
            _PLANS[key] = plan
            if len(_PLANS) > _PLANS_MAX:
                _PLANS.popitem(last=False)
        return plan
    _PLANS.move_to_end(key)
    if not x.is_contiguous():
        raise ValueError("axis_stencil: x must be contiguous")
    return plan


def _apply(wrapper, coeffs, x: torch.Tensor, dev: torch.device, march, chunk) -> torch.Tensor:
    """Launch ``wrapper``'s apply (``axis_stencil``, ``axis_stencil5``) on
    ``x`` (on ``dev``) through its launch plan."""
    _lib()  # loaded first: a CUDA tensor never falls back to the plain version
    plan = _plan(wrapper, coeffs, x, dev, march, chunk)
    out = torch.empty_like(x)
    plan(x, out)
    plan.wrapper.launches += 1
    if plan.row:
        axis_stencil.row_launches += 1
    record_kernel(plan.name, out)
    return out


def _apply_dot(coeffs, x: torch.Tensor, dev: torch.device, march, chunk):
    """Launch the alpha-dot on a 3-D ``x`` (on ``dev``) through its launch
    plan."""
    _lib()  # loaded first: a CUDA tensor never falls back to the plain version
    if x.ndim != 4:
        raise ValueError(f"axis_stencil_dot: x must be (vdim, nx, ny, nz), got {tuple(x.shape)}")
    plan = _plan(axis_stencil_dot, coeffs, x, dev, march, chunk)
    out = torch.empty_like(x)
    shape, cdt = plan.partial
    partial = torch.empty(shape, dtype=cdt, device=dev)
    plan(x, out, partial.data_ptr())
    axis_stencil_dot.launches += 1
    record_kernel("axis_stencil_dot", out, partial)
    return out, partial.sum(dim=1).reshape(shape[0], 1, 1, 1)


def _check_device(name: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")


def axis_stencil(coeffs, x: torch.Tensor, *, march=None, chunk=None) -> torch.Tensor:
    """``sum_a ap_a x[+1] + ac_a x + am_a x[-1]`` over mesh axes, torus wrap.

    Args:
        coeffs: per mesh axis, a 3-tuple of 1-D tensors ``(ap, ac, am)``.
        x: field values ``(vdim, *nx)``.
        march: the kernel of a CUDA tensor: None the shape's choice
            (``uses_march``, ``uses_row_march``), True the march (the
            plane march of a 3-D grid, the row march of a 2-D one), False
            the per-point kernel.
        chunk: the plane march's planes per block, the row march's rows
            per thread (None: ``march_geometry``'s, ``row_geometry``'s).

    A CPU tensor goes to the plain ``apply_axis_stencil``; a CUDA tensor
    launches a kernel on the current stream through the operator's launch
    plan (``_plan``: built once per coefficient tuple, shape, dtype and
    device), or raises. An equation with a 5-point axis takes
    ``axis_stencil5``'s kernels and counts among its launches."""
    dev = x.device
    if dev.type == "cpu":
        return apply_axis_stencil(coeffs, x)
    _check_device("axis_stencil", dev)
    return _apply(axis_stencil, coeffs, x, dev, march, chunk)


def axis_stencil_dot(coeffs, x: torch.Tensor, *, march=None, chunk=None):
    """``(A x, sum(x * A x))`` per component for a 3-D ``x``; the dot is
    taken in ``promote(dtype, f32)`` from the unrounded ``A x`` and comes
    back shaped ``(vdim, 1, 1, 1)``.

    ``march``: the kernel of a CUDA tensor (None: ``uses_march``, the
    shape alone; True the plane march, False the per-point kernel; True
    on a grid other than 3-D raises); ``chunk``: the march's planes per
    block. A CPU tensor goes to the plain ``apply_axis_stencil_dot``; a
    CUDA tensor launches a kernel on the current stream through its launch
    plan, or raises."""
    if march and x.ndim != 4:
        raise ValueError(f"axis_stencil_dot: the plane march takes 3-D grids, got "
                         f"{tuple(x.shape)}")
    dev = x.device
    if dev.type == "cpu":
        return apply_axis_stencil_dot(coeffs, x)
    _check_device("axis_stencil_dot", dev)
    return _apply_dot(coeffs, x, dev, march, chunk)


def axis_stencil5(coeffs, x: torch.Tensor, *, march=None, chunk=None) -> torch.Tensor:
    """``sum_a`` of each axis' 5-point ``app x[+2] + ap x[+1] + ac x + am
    x[-1] + amm x[-2]`` (or 3-point ``(ap, ac, am)``) terms, torus wrap.

    A CPU tensor goes to the plain ``apply_axis_stencil``; a CUDA tensor
    launches a radius-2 kernel on the current stream through its launch
    plan (``march``, ``chunk`` as in ``axis_stencil``; the row march is
    radius 1: True on a 2-D grid raises), or raises."""
    dev = x.device
    if dev.type == "cpu":
        return apply_axis_stencil(coeffs, x)
    _check_device("axis_stencil5", dev)
    return _apply(axis_stencil5, coeffs, x, dev, march, chunk)


def check_ext_inputs(coeffs, x_ext: torch.Tensor, ext, out=None) -> tuple:
    """Raise on what the halo-extended kernels do not take: a dtype other
    than bf16/f32/f64; ``x_ext`` not ``(vdim, n0 + 2 e0, n1 + 2 e1, n2)``
    (3-D) or not contiguous; ``ext`` not three 0/1 flags with ``ext[2] ==
    0``; coefficients not three contiguous 1-D vectors per axis of the
    unextended length in ``x_ext``'s dtype and device; an ``out`` of
    another shape, dtype or device, or with a last-axis stride other than
    1 (the wrapper checks the launch limits of the kernel it takes).
    Returns the unextended shape."""
    if x_ext.dtype not in _DTYPE_CODE:
        raise TypeError(f"axis_stencil_ext: dtype {x_ext.dtype} not supported (bf16, f32, f64)")
    if x_ext.ndim != 4:
        raise ValueError(f"axis_stencil_ext: x_ext must be (vdim, nx, ny, nz), got "
                         f"{tuple(x_ext.shape)}")
    ext = tuple(ext)
    if len(ext) != 3 or any(e not in (0, 1) for e in ext) or ext[2] != 0:
        raise ValueError(f"axis_stencil_ext: ext must be three 0/1 flags with ext[2] == 0, "
                         f"got {ext}")
    if not x_ext.is_contiguous():
        raise ValueError("axis_stencil_ext: x_ext must be contiguous")
    n = tuple(s - 2 * e for s, e in zip(x_ext.shape[1:], ext))
    if min(n) < 1:
        raise ValueError(f"axis_stencil_ext: empty block {n}")
    if len(coeffs) != 3:
        raise ValueError(f"axis_stencil_ext: {len(coeffs)} coefficient axes for 3 mesh axes")
    for a, cs in enumerate(coeffs):
        if len(cs) != 3:
            raise ValueError(f"axis_stencil_ext: axis {a} needs (ap, ac, am)")
        for c in cs:
            if (c.ndim != 1 or c.shape[0] != n[a] or c.dtype != x_ext.dtype
                    or c.device != x_ext.device or not c.is_contiguous()):
                raise ValueError(f"axis_stencil_ext: axis {a} coefficients must be contiguous "
                                 f"1-D {x_ext.dtype} of length {n[a]} on {x_ext.device}")
    if out is not None:
        if (tuple(out.shape) != (x_ext.shape[0], *n) or out.dtype != x_ext.dtype
                or out.device != x_ext.device or out.stride(-1) != 1):
            raise ValueError(f"axis_stencil_ext: out must be {(x_ext.shape[0], *n)} "
                             f"{x_ext.dtype} on {x_ext.device} with last-axis stride 1")
    return n


def axis_stencil_ext(coeffs, x_ext: torch.Tensor, ext, out: torch.Tensor | None = None, *,
                     march=None, chunk=None):
    """The 3-point axis stencil of a 3-D block extended by one ghost row
    per side of each axis with ``ext[a] == 1`` (``ext[2] == 0``): on an
    extended axis the neighbour is the next row of ``x_ext``, on the others
    it wraps. ``coeffs`` are sized to the unextended block; the result has
    the unextended shape and is written into ``out`` when given (any
    strides with last-axis stride 1, e.g. the block's view of a global
    tensor), else into a new tensor.

    ``march``: the kernel of a CUDA tensor (None: ``uses_march_ext``, the
    block's shape and the output view alone; True the plane march, False
    the per-point kernel); ``chunk``: the march's planes per block. A CPU
    tensor goes to the plain ``apply_axis_stencil_ext``; a CUDA tensor
    launches a kernel on the current stream, or raises."""
    if x_ext.device.type == "cpu":
        check_ext_inputs(coeffs, x_ext, ext, out)
        r = apply_axis_stencil_ext(coeffs, x_ext, ext)
        return r if out is None else out.copy_(r)
    if x_ext.device.type != "cuda":
        raise ValueError(f"axis_stencil_ext: unsupported device {x_ext.device}")
    lib = _lib()  # loaded first: a CUDA tensor never falls back to the plain version
    n = check_ext_inputs(coeffs, x_ext, ext, out)
    vdim = x_ext.shape[0]
    if out is None:
        out = torch.empty((vdim, *n), dtype=x_ext.dtype, device=x_ext.device)
    shape = (vdim, *n)
    march = uses_march_ext(shape, out) if march is None else bool(march)
    stream = torch.cuda.current_stream(x_ext.device).cuda_stream
    dtype = _DTYPE_CODE[x_ext.dtype]
    e0, e1 = int(ext[0]), int(ext[1])
    with torch.cuda.device(x_ext.device):
        if march:
            ci, _ = _march_geometry("axis_stencil_ext", lib, x_ext, shape, _EXT, chunk)
            cptrs = (ctypes.c_void_p * 15)(*(p for cs in coeffs
                                             for p in (None, *(c.data_ptr() for c in cs), None)))
            err = lib.pyapes_axis_march_ext(
                dtype, vdim, *n, e0, e1, x_ext.data_ptr(), out.data_ptr(), *out.stride()[:3],
                int(pair_stores(out)), cptrs, ci, copy_bytes(x_ext, n[2], [x_ext]), stream)
        else:
            if n[1] > _MAX_GRID_YZ or vdim * n[0] > _MAX_GRID_YZ:
                raise ValueError(f"axis_stencil_ext: block {n} exceeds the launch limits")
            cptrs = (ctypes.c_void_p * 9)(*(c.data_ptr() for cs in coeffs for c in cs))
            err = lib.pyapes_axis_stencil_ext(dtype, vdim, *n, e0, e1, x_ext.data_ptr(),
                                              out.data_ptr(), *out.stride()[:3], cptrs, stream)
    cuda_build.check(lib, err, "axis_stencil_ext")
    axis_stencil_ext.launches += 1
    record_kernel("axis_stencil_ext", out)
    return out


axis_stencil.launches = 0
axis_stencil.row_launches = 0  # of them, the row march's (2-D)
axis_stencil_dot.launches = 0
axis_stencil5.launches = 0
axis_stencil_ext.launches = 0
