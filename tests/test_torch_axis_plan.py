"""The axis stencil's launch plans and the row march's geometry, on the CPU.

A CUDA tensor reaches the kernels through a launch plan
(``ops/axis_stencil.py``: ``_plan``, ``_Plan``): built and checked once per
coefficient tuple, shape, dtype and device, it holds the kernel's choice,
its geometry and its arguments (``AxisPlan`` of ``csrc/axis_stencil.cu``);
a call passes only x, out, the dot's partials and the current stream. The
kernels run on the card only (``tests/test_torch_cuda.py``). Here a stand-in
for the kernel library (``_FakeLib``) reads the plan the wrapper hands to
``pyapes_axis_plan_launch`` and computes what it names with the plain
version, from the tensors behind its pointers, so that:

* the plan path gives the plain version's bits in 1-D, 2-D and 3-D, at
  radius 1 and 2 and for the alpha-dot, with every kernel's layout of the
  coefficient pointers, extents, dtype code, 5-point bits and partials;
* every input that ``check_inputs`` rejects raises at plan build;
* a new coefficient tuple gets a new plan, a kept one is reused, a freed
  one never aliases, a list is planned on every call, and the stream is
  read on every call;
* the 2-D apply through a plan matches JAX's ``pallas_axis_stencil`` in
  interpret mode on the rz and channel Laplacian vectors;
* the row march's blocks cover every output point of every component
  once.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.geometry import Box as JBox, Cylinder as JCylinder  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.ops import stencil as jstencil  # noqa: E402
from pyapes_tpu.ops.pallas_stencil import pallas_axis_stencil  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu.variables.bcs import CylinderBoundary as JCylinderBoundary  # noqa: E402
from pyapes_tpu_torch.geometry import Box, Cylinder  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops import axis_stencil as amod  # noqa: E402
from pyapes_tpu_torch.ops import stencil as pstencil  # noqa: E402
from pyapes_tpu_torch.ops.stencil import apply_axis_stencil, apply_axis_stencil_dot  # noqa: E402
from pyapes_tpu_torch.utils.carry import coeffs_from_numpy  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import CylinderBoundary  # noqa: E402

WRAPPERS = (amod.axis_stencil, amod.axis_stencil5, amod.axis_stencil_dot)
SMS, RESIDENT = 132, 132 * 16  # an H100's SMs, the plane march's blocks it holds at once
# the plan's kinds (csrc/axis_stencil.cu) and their coefficient layout:
# 3 pointers (ap, ac, am) or 5 (app, ap, ac, am, amm) per mesh axis
WIDTH = {amod._PLAN_POINT: 3, amod._PLAN_POINT_DOT: 3, amod._PLAN_ROW: 3,
         amod._PLAN_POINT5: 5, amod._PLAN_MARCH: 5, amod._PLAN_MARCH_DOT: 5}
TOL = 1e-12  # relative, float64: the plain version and the JAX kernel sum in other orders


class _FakeLib:
    """The kernel library's plan entry on the CPU: reads the ``AxisPlan``
    at ``addr``, checks it against the operand behind ``x``, and writes the
    plain version of what it names into ``out`` (and the dot's partials:
    one per block, the component's dot in its first)."""

    def __init__(self):
        self.by_ptr, self.calls = {}, []

    def register(self, *tensors):
        for t in tensors:
            self.by_ptr[t.data_ptr()] = t

    def pyapes_axis_plan_launch(self, addr, xp, outp, partial, stream):
        a = amod._PlanArgs.from_address(addr)
        x = self.by_ptr[xp]
        ndim, kind = x.ndim - 1, a.kind
        assert (a.dtype, a.ndim, a.vdim) == (amod._DTYPE_CODE[x.dtype], ndim, x.shape[0])
        assert list(a.n) == list(x.shape[1:]) + [1] * (3 - ndim)
        assert a.cw in (0, 4, 8, 16) and (a.cw == 0 or x.shape[-1] * x.element_size() % a.cw == 0)
        width = WIDTH[kind]
        ptrs = list(a.coeffs)
        assert all(p is None for p in ptrs[width * ndim:])
        coeffs, five = [], 0
        for ax in range(ndim):
            cs = ptrs[width * ax:width * (ax + 1)]
            if width == 5:
                if cs[0] is None:
                    assert cs[4] is None
                    cs = cs[1:4]
                else:
                    five |= 1 << ax
            coeffs.append(tuple(self.by_ptr[p] for p in cs))
        if kind == amod._PLAN_MARCH:
            assert ndim == 3 and a.ci >= 1 and a.five == five and a.radius in (1, 2)
        if kind == amod._PLAN_ROW:
            assert ndim == 2 and a.ci in amod._ROW_CHUNKS
        dot = kind in (amod._PLAN_POINT_DOT, amod._PLAN_MARCH_DOT)
        assert (partial is not None) == dot
        self.calls.append((kind, stream))
        if dot:
            res, d = apply_axis_stencil_dot(tuple(coeffs), x)
            n0, n1, n2 = x.shape[1:]
            per = (n0 * n1 * -(-n2 // amod._THREADS) if kind == amod._PLAN_POINT_DOT else
                   -(-n0 // a.ci) * -(-n1 // amod._TILE[0]) * -(-n2 // amod._TILE[1]))
            parts = torch.zeros((x.shape[0], per), dtype=d.dtype)
            parts[:, 0] = d.reshape(-1)
            ctypes.memmove(partial, parts.data_ptr(), parts.numel() * parts.element_size())
        else:
            res = apply_axis_stencil(tuple(coeffs), x)
        res = res.contiguous()
        ctypes.memmove(outp, res.data_ptr(), res.numel() * res.element_size())
        return 0


@pytest.fixture
def fake(monkeypatch):
    """The plan path on CPU tensors: the stand-in library, the card's
    resident blocks, the current device and a stream handle; the wrappers'
    launch counts restored afterwards."""
    lib = _FakeLib()
    lib.stream = 7
    monkeypatch.setattr(amod, "_lib", lambda: lib)
    monkeypatch.setattr(amod, "resident_blocks", lambda *args: RESIDENT)
    monkeypatch.setattr(amod, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(amod, "_current_device", lambda: None)
    monkeypatch.setattr(amod, "_current_stream", lambda index: lib.stream)
    for fn in WRAPPERS:
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(amod.axis_stencil, "row_launches", amod.axis_stencil.row_launches)
    amod._PLANS.clear()
    yield lib
    amod._PLANS.clear()


def _inputs(lib, shape, points, dtype=torch.float64, seed=5):
    rng = np.random.default_rng(seed)
    coeffs = tuple(tuple(torch.from_numpy(rng.standard_normal(n)).to(dtype) for _ in range(p))
                   for n, p in zip(shape[1:], points))
    x = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    lib.register(x, *(c for cs in coeffs for c in cs))
    return coeffs, x


# (shape, points per axis, march, the plan's kind)
APPLY_CASES = [
    ((2, 13), (3,), None, amod._PLAN_POINT),
    ((1, 11), (5,), None, amod._PLAN_POINT5),
    ((1, 9, 83), (3, 3), None, amod._PLAN_POINT),
    ((1, 128, 1024), (3, 3), None, amod._PLAN_ROW),
    ((3, 5, 130), (3, 3), True, amod._PLAN_ROW),
    ((1, 9, 83), (3, 3), True, amod._PLAN_ROW),
    ((1, 9, 83), (3, 3), False, amod._PLAN_POINT),
    ((2, 9, 33), (5, 3), None, amod._PLAN_POINT5),
    ((1, 7, 9, 11), (3, 3, 3), None, amod._PLAN_POINT),
    ((1, 7, 9, 11), (3, 3, 3), True, amod._PLAN_MARCH),
    ((2, 5, 16, 128), (5, 3, 5), True, amod._PLAN_MARCH),
    ((1, 5, 16, 128), (3, 5, 3), False, amod._PLAN_POINT5),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, points, march, kind", APPLY_CASES)
def test_plan_path_gives_the_plain_bits(fake, shape, points, march, kind, dtype):
    """``axis_stencil`` through its plan: the kernel the shape (or
    ``march``) picks, its arguments as the library reads them, the plain
    version's bits, one launch counted on the wrapper of the equation's
    radius (a 5-point equation on ``axis_stencil5``), and among
    ``axis_stencil.row_launches`` where the row march ran."""
    coeffs, x = _inputs(fake, shape, points, dtype)
    wrapper = amod.axis_stencil5 if 5 in points else amod.axis_stencil
    before = [fn.launches for fn in WRAPPERS] + [amod.axis_stencil.row_launches]
    out = amod._apply(amod.axis_stencil, coeffs, x, x.device, march, None)
    assert torch.equal(out, apply_axis_stencil(coeffs, x))
    assert fake.calls == [(kind, fake.stream)]
    after = [fn.launches for fn in WRAPPERS] + [amod.axis_stencil.row_launches]
    assert [a - b for a, b in zip(after, before)] == [int(fn is wrapper) for fn in WRAPPERS] + [
        int(kind == amod._PLAN_ROW)]


@pytest.mark.parametrize("shape, march, kind", [
    ((1, 7, 9, 11), None, amod._PLAN_POINT_DOT), ((2, 7, 9, 11), True, amod._PLAN_MARCH_DOT),
    ((1, 9, 32, 256), True, amod._PLAN_MARCH_DOT), ((3, 4, 16, 128), False, amod._PLAN_POINT_DOT)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dot_plan_gives_the_plain_bits(fake, shape, march, kind, dtype):
    """``axis_stencil_dot`` through its plan: ``A x`` with the plain bits
    and the dot summed from partials laid out as the kernel writes them."""
    coeffs, x = _inputs(fake, shape, (3, 3, 3), dtype)
    before = amod.axis_stencil_dot.launches
    out, dot = amod._apply_dot(coeffs, x, x.device, march, None)
    ref, ref_dot = apply_axis_stencil_dot(coeffs, x)
    assert torch.equal(out, ref) and torch.equal(dot, ref_dot)
    assert fake.calls == [(kind, fake.stream)] and amod.axis_stencil_dot.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_5point_wrapper_plans_radius_2_on_3_point_axes(fake, dtype):
    """``axis_stencil5`` with 3-point axes only takes the radius-2 kernels
    (null ``app``/``amm``), never the row march."""
    coeffs, x = _inputs(fake, (1, 9, 83), (3, 3), dtype)
    out = amod._apply(amod.axis_stencil5, coeffs, x, x.device, None, None)
    assert torch.equal(out, apply_axis_stencil(coeffs, x))
    assert fake.calls[-1][0] == amod._PLAN_POINT5


def _bad_inputs(lib, case):
    """``tests/test_torch_stencil.py``'s cases of ``check_inputs`` (x of
    (1, 5, 6, 7) unless the case needs another)."""
    coeffs, x = _inputs(lib, (1, 5, 6, 7), (3, 3, 3))
    c = list(coeffs)
    if case == "dtype":
        return tuple(tuple(v.half() for v in cs) for cs in coeffs), x.half()
    if case == "noncontig":
        return coeffs, x.transpose(1, 3)
    if case == "axes":
        return tuple(c[:2]), x
    if case == "five_point":
        c[0] = c[0] + c[0][:2]
        return tuple(c), x
    if case == "length":
        c[1] = (c[1][0][:-1], c[1][1], c[1][2])
        return tuple(c), x
    if case == "coeff_dtype":
        c[2] = tuple(v.float() for v in c[2])
        return tuple(c), x
    if case == "too_small":
        return _inputs(lib, (1, 2, 6, 7), (3, 3, 3))
    if case == "launch_limit":
        return _inputs(lib, (1, 70000, 3), (3, 3))
    raise AssertionError(case)


BAD_CASES = [("dtype", TypeError), ("noncontig", ValueError), ("axes", ValueError),
             ("five_point", NotImplementedError), ("length", ValueError),
             ("coeff_dtype", ValueError), ("too_small", ValueError),
             ("launch_limit", ValueError)]


@pytest.mark.parametrize("case, exc", BAD_CASES)
def test_plan_build_raises_what_check_inputs_rejects(fake, case, exc):
    """Every input ``check_inputs`` rejects raises when the plan is built,
    and launches nothing: the 5-point case through the alpha-dot (a CG
    operator is 3-point), the launch limit on the per-point kernel (the
    row march takes that grid: ``test_row_march_takes_tall_2d_grids``)."""
    coeffs, x = _bad_inputs(fake, case)
    with pytest.raises(exc):
        if case == "five_point":
            amod._apply_dot(coeffs, x, x.device, None, None)
        else:
            march = False if case == "launch_limit" else None
            amod._apply(amod.axis_stencil, coeffs, x, x.device, march, None)
    assert fake.calls == [] and not amod._PLANS


def test_row_march_takes_tall_2d_grids(fake):
    """A 2-D grid beyond the per-point kernel's 65535 rows takes the row
    march (its rows are a loop and a grid index along x), with the plain
    bits."""
    coeffs, x = _inputs(fake, (1, 70000, 3), (3, 3))
    assert torch.equal(amod._apply(amod.axis_stencil, coeffs, x, x.device, None, None),
                       apply_axis_stencil(coeffs, x))
    assert fake.calls == [(amod._PLAN_ROW, fake.stream)]


@pytest.mark.parametrize("wrapper, shape, points", [
    (amod.axis_stencil, (2, 13), (3,)), (amod.axis_stencil5, (1, 9, 33), (5, 3)),
    (amod.axis_stencil, (1, 9, 33), (5, 3)), (amod.axis_stencil5, (1, 13), (5,))])
def test_forced_march_raises_where_no_march_takes_the_grid(fake, wrapper, shape, points):
    """``march=True`` on a 1-D grid, or on a 2-D grid at radius 2, raises:
    the plane march takes 3-D grids, the row march the 2-D grids of the
    3-point apply; nothing falls back."""
    coeffs, x = _inputs(fake, shape, points)
    with pytest.raises(ValueError):
        amod._apply(wrapper, coeffs, x, x.device, True, None)
    assert fake.calls == []


def test_a_kept_tuple_reuses_its_plan_and_a_new_tuple_gets_its_own(fake):
    coeffs, x = _inputs(fake, (1, 9, 83), (3, 3))
    amod._apply(amod.axis_stencil, coeffs, x, x.device, None, None)
    (plan,) = amod._PLANS.values()
    y = x.clone()
    fake.register(y)
    amod._apply(amod.axis_stencil, coeffs, y, y.device, None, None)
    assert list(amod._PLANS.values()) == [plan] and plan.coeffs is coeffs
    same_tensors = tuple(tuple(cs) for cs in coeffs)
    amod._apply(amod.axis_stencil, same_tensors, x, x.device, None, None)
    assert len(amod._PLANS) == 2 and list(amod._PLANS.values())[-1].coeffs is same_tensors
    for march, chunk in ((False, None), (True, 3)):  # another kernel or chunk: another plan
        amod._apply(amod.axis_stencil, coeffs, x, x.device, march, chunk)
    assert len(amod._PLANS) == 4
    assert [k for k, _ in fake.calls] == [amod._PLAN_POINT] * 4 + [amod._PLAN_ROW]


def test_a_freed_tuple_never_aliases(fake, monkeypatch):
    """Plans hold their tuples, so an id is not reused while its plan
    lives; once evicted (two plans kept here), a new tuple at a reused id
    gets its own plan. Each of many short-lived operators gives its own
    result."""
    monkeypatch.setattr(amod, "_PLANS_MAX", 2)
    x = _inputs(fake, (1, 9, 40), (3, 3), seed=1)[1]
    for seed in range(40):
        coeffs, _ = _inputs(fake, (1, 9, 40), (3, 3), seed=100 + seed)
        assert torch.equal(amod._apply(amod.axis_stencil, coeffs, x, x.device, None, None),
                           apply_axis_stencil(coeffs, x)), seed
        assert len(amod._PLANS) <= 2
        assert next(reversed(amod._PLANS.values())).coeffs is coeffs
        assert all(id(p.coeffs) == key[1] for key, p in amod._PLANS.items())
        del coeffs


def test_a_list_is_planned_on_every_call(fake):
    """A list may be refilled between calls: it is never kept, and each
    call reads its current vectors."""
    coeffs, x = _inputs(fake, (1, 9, 33), (3, 3))
    lst = [list(cs) for cs in coeffs]
    first = amod._apply(amod.axis_stencil, lst, x, x.device, None, None)
    lst[1][1] = lst[1][1] * 2.0
    fake.register(lst[1][1])
    second = amod._apply(amod.axis_stencil, lst, x, x.device, None, None)
    assert not amod._PLANS
    assert torch.equal(first, apply_axis_stencil(coeffs, x))
    assert torch.equal(second, apply_axis_stencil(lst, x)) and not torch.equal(first, second)


def test_a_kept_plan_still_checks_contiguity_and_reads_the_stream(fake):
    """A plan keeps no stream (a graph capture launches on its own) and a
    kept plan still rejects a non-contiguous x."""
    coeffs, x = _inputs(fake, (1, 9, 33), (3, 3))
    amod._apply(amod.axis_stencil, coeffs, x, x.device, None, None)
    fake.stream = 11
    amod._apply(amod.axis_stencil, coeffs, x, x.device, None, None)
    assert [s for _, s in fake.calls] == [7, 11]
    view = torch.empty((1, 33, 9), dtype=x.dtype).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        amod._apply(amod.axis_stencil, coeffs, view, view.device, None, None)
    assert len(fake.calls) == 2


@pytest.mark.parametrize("shape, row", [
    ((1, 512, 1024), True), ((1, 256, 512), True), ((3, 128, 1024), True), ((1, 1025, 1025), True),
    ((1, 1761, 329), True), ((1, 70000, 3), True), ((1, 255, 512), False), ((1, 257, 257), False),
    ((1, 441, 83), False), ((2, 221, 42), False), ((1, 3, 3), False), ((1, 131071, 1), False),
    ((1, 512), False), ((1, 64, 64, 64), False), ((1, 512, 512, 512), False)])
def test_row_march_choice_follows_the_shape_alone(shape, row):
    """The row march takes 2-D grids of at least ``ROW_MIN_POINTS`` points
    per component; smaller 2-D grids (the 2D-2 channel's), 1-D and 3-D
    grids do not."""
    assert amod.uses_row_march(shape) is row
    assert row == (len(shape) == 3 and shape[1] * shape[2] >= amod.ROW_MIN_POINTS)


@pytest.mark.parametrize("shape", [(1, 3, 3), (1, 441, 83), (2, 17, 129), (1, 512, 1024),
                                   (3, 7, 1023), (1, 221, 42), (1, 70000, 3)])
@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("chunk", [None, 1, 3, 4, 8, 10**6])
def test_row_geometry_covers_each_point_once(shape, size, chunk):
    """Each row-march thread's rows and columns, read off its thread index
    as the kernel reads them, cover every point of every component once;
    no chunk crosses a component; the chunk is one the kernel is built
    for, the longest not above a given one."""
    vdim, n0, n1 = shape
    ci, v, blocks = amod.row_geometry(shape, size, SMS, chunk)
    assert ci in amod._ROW_CHUNKS and (chunk is None or ci == max(
        c for c in amod._ROW_CHUNKS if c <= chunk))
    assert v == (16 // size if n1 * size % 16 == 0 else 1) and n1 % v == 0
    groups, nch = n1 // v, -(-n0 // ci)
    t = np.arange(blocks * amod._ROW_THREADS)
    t = t[t < vdim * nch * groups]
    g, c, d = t % groups, (t // groups) % nch, t // (groups * nch)
    hits = np.zeros(shape, dtype=np.int64)
    for gg, cc, dd in zip(g, c, d):
        hits[dd, cc * ci:min(cc * ci + ci, n0), gg * v:gg * v + v] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("shape, size, ci", [((1, 512, 1024), 4, 4), ((1, 441, 83), 8, 2),
                                             ((1, 256, 512), 4, 1), ((1, 221, 42), 8, 1),
                                             ((3, 4097, 4097), 8, 8)])
def test_row_chunk_keeps_the_sms_busy(shape, size, ci):
    """The default chunk: the longest that leaves at least one block per SM
    (the rz cell's 512 x 1024 f32 takes 4 rows per thread, the 2D-2 grid's
    odd rows one column and 2 rows per thread)."""
    got, _, blocks = amod.row_geometry(shape, size, SMS)
    assert got == ci
    assert blocks >= SMS or ci == 1


# -- the 2-D apply on the rz and channel vectors against JAX's kernel ----
def _rz_operator(shape):
    """The rz Laplacian of the potentials' faces (symmetry at r = 0,
    Dirichlet elsewhere) in both packages."""
    faces = {"rl": ("symmetry", None), "ru": ("dirichlet", 0.0), "zl": ("dirichlet", 0.0),
             "zu": ("dirichlet", 0.0)}
    jm = JMesh(JCylinder[0:4, -4:4], None, list(shape), dtype="double")
    pm = Mesh(Cylinder[0:4, -4:4], None, list(shape), device="cpu", dtype="double")
    jf = JField("h", 1, jm, {"domain": JCylinderBoundary(**{
        f: {"bc_type": t, "bc_val": v} for f, (t, v) in faces.items()})(), "obstacle": None})
    pf = Field("h", 1, pm, {"domain": CylinderBoundary(**{
        f: {"bc_type": t, "bc_val": v} for f, (t, v) in faces.items()})(), "obstacle": None})
    return (jstencil.laplacian_axis_coeffs(jm, jf.bcs),
            pstencil.laplacian_axis_coeffs(pm, pf.bcs))


def _channel_operator(shape, field):
    """The 2D-2 channel's Laplacian of ``field`` ("u": Dirichlet inlet,
    Neumann outlet, no-slip walls; "p": Neumann inlet and walls, Dirichlet
    outlet) in both packages."""
    d0 = {"bc_type": "dirichlet", "bc_val": 0.0}
    nm = {"bc_type": "neumann", "bc_val": 0.0}
    inlet, outlet, wall = ((dict(d0, bc_val=1.0), nm, d0) if field == "u" else (nm, d0, nm))
    faces = [dict(bc_face=f, bc_val_opt=None, **b)
             for f, b in zip(("xl", "xu", "yl", "yu"), (inlet, outlet, wall, wall))]
    jm = JMesh(JBox[0:2.2, 0:0.41], None, list(shape), dtype="double")
    pm = Mesh(Box[0:2.2, 0:0.41], None, list(shape), device="cpu", dtype="double")
    jf = JField(field, 1, jm, {"domain": faces, "obstacle": None})
    pf = Field(field, 1, pm, {"domain": faces, "obstacle": None})
    return (jstencil.laplacian_axis_coeffs(jm, jf.bcs),
            pstencil.laplacian_axis_coeffs(pm, pf.bcs))


@pytest.mark.parametrize("march, kind", [(None, amod._PLAN_POINT), (True, amod._PLAN_ROW)])
@pytest.mark.parametrize("operator", ["rz", "channel u", "channel p"])
@pytest.mark.parametrize("shape", [(16, 128), (32, 256)])
def test_plan_2d_matches_jax_pallas(fake, operator, shape, march, kind):
    """The 2-D f64 apply through its plan (the shape's choice, and the row
    march's plan) against ``pallas_stencil.py:432`` in interpret mode, each
    on its package's vectors, within 1e-12 of the result's scale."""
    if operator == "rz":
        jc, pc = _rz_operator(shape)
    else:
        jc, pc = _channel_operator(shape, operator.split()[1])
    x = np.random.default_rng(4).standard_normal((1, *shape))
    coeffs = coeffs_from_numpy(pc, "cpu", torch.float64)
    xt = torch.from_numpy(x)
    fake.register(xt, *(c for cs in coeffs for c in cs))
    got = amod._apply(amod.axis_stencil, coeffs, xt, xt.device, march, None).numpy()
    want = np.asarray(pallas_axis_stencil(tuple(tuple(jnp.asarray(c) for c in cs) for cs in jc),
                                          jnp.asarray(x), interpret=True))
    assert fake.calls == [(kind, fake.stream)]
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
