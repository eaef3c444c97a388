"""The implicit-advection operators of the port against the JAX package
(CPU, float64).

* ``div_axis_coeffs`` (central, upwind and QUICK's 5-vectors, with the
  Neumann/Symmetry elimination) against the JAX function: the same numpy
  code, held to 1e-12 relative.
* The plain ``apply_div_field`` / ``apply_conv_field`` / 5-point
  ``apply_axis_stencil`` against the JAX jnp versions on EVERY row: every
  limiter, both Div forms, the surgery kinds none / neumann / periodic,
  scalar and vector targets, 1-, 2- and 3-D grids, and an axis of 3 nodes
  with Neumann faces on both sides. 1e-12 relative.
* The plain versions against the TPU kernels ``pallas_advect_pair``,
  ``pallas_conv_component`` and ``pallas_axis_stencil_v5`` in interpret
  mode at ``(8, 16, 128)``, the shape ``tests/test_pallas.py`` runs the
  5-point kernel at. The kernels wrap every neighbour index as the plain
  versions do, so the comparison is on every row; 1e-12 relative. Axes
  with two Neumann faces have >= 8 nodes here: on a 3-node axis the TPU
  kernels add both faces' eliminations from the pre-surgery coefficients
  while the jnp path applies them in sequence, and the two disagree by
  O(1) (a fault of the reference, not copied; ROADMAP C).

On the CPU the wrappers ``advect_pair`` / ``conv_component`` /
``axis_stencil5`` are the plain versions, check what the kernels take,
and count no launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.ops import stencil as jst  # noqa: E402
from pyapes_tpu.ops.pallas_advect import pallas_advect_pair, pallas_conv_component  # noqa: E402
from pyapes_tpu.ops.pallas_stencil_v3 import pallas_axis_stencil_v5  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops import advect  # noqa: E402
from pyapes_tpu_torch.ops import stencil as pst  # noqa: E402
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil, axis_stencil5  # noqa: E402
from pyapes_tpu_torch.utils.carry import gamma_from_numpy  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402

FACES = ["xl", "xu", "yl", "yu", "zl", "zu"]
SURGERY = {  # per kind, the (lower, upper) faces of axes 0, 1, 2
    "none": (("none", "none"),) * 3,
    "neumann": (("neumann", "neumann"),) * 3,
    "mixed": (("periodic", "neumann"), ("none", "periodic"), ("neumann", "none")),
}
DIV_VARIANTS = [("none", "conservative"), ("none", "advective"), ("upwind", "conservative"),
                ("quick", "conservative")]
# every grid has >= 3 nodes per axis; (3, 7, 6) puts 3 nodes on the
# axis that the "neumann" kind gives two Neumann faces
SHAPES = [(9, 8, 10), (3, 7, 6), (12, 5), (11,)]
KSHAPE = (8, 16, 128)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _meshes(shape, lengths=(1.0, 2.0, 0.5)):
    lx = lengths[: len(shape)]
    jbox = JBox[tuple(slice(0, l) for l in lx)]
    pbox = Box[tuple(slice(0, l) for l in lx)]
    return (JMesh(jbox, None, list(shape), dtype="double"),
            Mesh(pbox, None, list(shape), device="cpu", dtype="double"))


def _bases(shape):
    """The geometry-only base vectors of both packages (JAX, port)."""
    jm, pm = _meshes(shape)
    jb = jst.div_axis_coeffs(jm, None, 1.0, "none")
    pb = pst.div_axis_coeffs(pm, None, 1.0, "none")
    return (tuple(tuple(jnp.asarray(c) for c in cs) for cs in jb),
            tuple(tuple(_t(c) for c in cs) for cs in pb))


def _inputs(shape, vdim, n_adv, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((vdim,) + shape), rng.standard_normal((n_adv,) + shape)


# -- constant-advection coefficients ---------------------------------------

@pytest.mark.parametrize("gamma", [0.7, -1.3])
@pytest.mark.parametrize("kinds", ["dirichlet", "mixed"])
@pytest.mark.parametrize("limiter", ["none", "upwind", "quick"])
@pytest.mark.parametrize("shape", [(9, 8, 10), (7, 12)])
def test_div_axis_coeffs_vs_jax(shape, limiter, kinds, gamma):
    nd = len(shape)
    types = (["dirichlet"] * 6 if kinds == "dirichlet"
             else ["neumann", "dirichlet", "symmetry", "neumann", "dirichlet", "neumann"])
    cfg = [{"bc_face": f, "bc_type": t, "bc_val": 0.0, "bc_val_opt": None}
           for f, t in zip(FACES[: 2 * nd], types[: 2 * nd])]
    jm, pm = _meshes(shape)
    jv = JField("c", 1, jm, {"domain": cfg, "obstacle": None})
    pv = Field("c", 1, pm, {"domain": cfg, "obstacle": None})
    ref = jst.div_axis_coeffs(jm, jv.bcs, gamma, limiter)
    got = pst.div_axis_coeffs(pm, pv.bcs, gamma, limiter)
    width = 5 if limiter == "quick" else 3
    assert [len(cs) for cs in got] == [width] * nd
    for cs_ref, cs_got in zip(ref, got):
        for r, g in zip(cs_ref, cs_got):
            assert g.dtype == np.float64
            assert np.abs(g - r).max() <= 1e-12 * np.abs(r).max() + 1e-300


# -- plain versions against the JAX jnp versions, every row ----------------

@pytest.mark.parametrize("vdim", [1, 3])
@pytest.mark.parametrize("kind", sorted(SURGERY))
@pytest.mark.parametrize("variant", DIV_VARIANTS, ids=lambda v: f"{v[0]}-{v[1][:4]}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_apply_div_field_vs_jax(shape, variant, kind, vdim):
    limiter, form = variant
    nd = len(shape)
    vdim = min(vdim, nd)
    surg = SURGERY[kind][:nd]
    jb, pb = _bases(shape)
    for n_adv in sorted({1, vdim}):
        x, a = _inputs(shape, vdim, n_adv, 10 + nd + vdim)
        ref = jst.apply_div_field(jnp.asarray(x), jnp.asarray(a), jb, limiter, surg, form)
        xt = _t(x)
        got = pst.apply_div_field(xt, gamma_from_numpy(a, xt), pb, limiter, surg, form)
        assert tuple(got.shape) == (1,) + shape
        assert _rel(got.numpy(), ref) <= 1e-12, n_adv


@pytest.mark.parametrize("kind", sorted(SURGERY))
@pytest.mark.parametrize("limiter", ["none", "upwind", "quick"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_apply_conv_field_vs_jax(shape, limiter, kind):
    nd = len(shape)
    surg = SURGERY[kind][:nd]
    jb, pb = _bases(shape)
    x, a = _inputs(shape, 2, nd, 20 + nd)
    ref = jst.apply_conv_field(jnp.asarray(x), jnp.asarray(a), jb, limiter, surg)
    got = pst.apply_conv_field(_t(x), _t(a), pb, limiter, surg)
    assert tuple(got.shape) == (2,) + shape
    assert _rel(got.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("op", ["div-none-cons", "div-none-adve", "div-upwind", "div-quick",
                                "conv-none", "conv-upwind", "conv-quick"])
def test_three_node_double_neumann_axis_follows_the_plain_reference(op):
    """An axis of 3 nodes with Neumann faces on both sides: both
    eliminations edit its one interior row, the upper reading what the
    lower left. The port's plain version equals the JAX plain version
    there (the JAX TPU kernels do not: ROADMAP C)."""
    shape = (3, 9, 6)
    surg = (("neumann", "neumann"), ("neumann", "none"), ("none", "neumann"))
    jb, pb = _bases(shape)
    kind, limiter, *form = op.split("-")
    form = {"cons": "conservative", "adve": "advective"}.get(form[0] if form else "", "conservative")
    for vdim in (1, 3):
        x, a = _inputs(shape, vdim, 3, 31 + vdim)
        if kind == "div":
            a = a[:vdim]
            ref = jst.apply_div_field(jnp.asarray(x), jnp.asarray(a), jb, limiter, surg, form)
            got = pst.apply_div_field(_t(x), _t(a), pb, limiter, surg, form)
        else:
            ref = jst.apply_conv_field(jnp.asarray(x), jnp.asarray(a), jb, limiter, surg)
            got = pst.apply_conv_field(_t(x), _t(a), pb, limiter, surg)
        assert _rel(got.numpy(), ref) <= 1e-12, vdim
        # the interior row of the 3-node axis really carries both edits
        assert np.abs(np.asarray(ref)[:, 1]).max() > 0


def _coeffs5(shape, rng, widths):
    return tuple(tuple(rng.standard_normal(n) for _ in range(w)) for n, w in zip(shape, widths))


@pytest.mark.parametrize("shape", [(9, 8, 10), (5, 3, 7), (12, 5), (11,)],
                         ids=lambda s: "x".join(map(str, s)))
def test_apply_axis_stencil_5pt_vs_jax(shape):
    """Mixed 5- and 3-point axes (torus wrap at the +-2 reach, 3-node axes
    included), and the QUICK equation's own vectors."""
    rng = np.random.default_rng(40 + len(shape))
    x = rng.standard_normal((2,) + shape)
    widths = (5, 3, 5)[: len(shape)]
    cs = _coeffs5(shape, rng, widths)
    ref = jst.apply_axis_stencil(tuple(tuple(jnp.asarray(c) for c in c3) for c3 in cs),
                                 jnp.asarray(x))
    tc = tuple(tuple(_t(c) for c in c3) for c3 in cs)
    got = pst.apply_axis_stencil(tc, _t(x))
    assert _rel(got.numpy(), ref) <= 1e-12
    before = (axis_stencil.launches, axis_stencil5.launches)
    assert torch.equal(axis_stencil(tc, _t(x)), got)
    assert torch.equal(axis_stencil5(tc, _t(x)), got)
    assert (axis_stencil.launches, axis_stencil5.launches) == before

    jm, pm = _meshes(shape)
    jq = jst.div_axis_coeffs(jm, None, 0.8, "quick")
    pq = pst.div_axis_coeffs(pm, None, 0.8, "quick")
    ref = jst.apply_axis_stencil(tuple(tuple(jnp.asarray(c) for c in c5) for c5 in jq),
                                 jnp.asarray(x))
    got = axis_stencil(tuple(tuple(_t(c) for c in c5) for c5 in pq), _t(x))
    assert _rel(got.numpy(), ref) <= 1e-12


# -- plain versions against the TPU kernels in interpret mode --------------

@pytest.mark.parametrize("kind", sorted(SURGERY))
@pytest.mark.parametrize("variant", DIV_VARIANTS[:3], ids=lambda v: f"{v[0]}-{v[1][:4]}")
def test_advect_pair_vs_jax_pallas_interpret(variant, kind):
    """``pallas_advect_pair`` as the JAX operator calls it: one launch over
    the three axes for a scalar target, one per (axis, component) pair for
    a vector one (``linalg.py:162-182``)."""
    limiter, form = variant
    surg = SURGERY[kind]
    jb, pb = _bases(KSHAPE)
    for vdim in (1, 3):
        x, a = _inputs(KSHAPE, vdim, vdim, 50 + vdim)
        if vdim == 1:
            ref = pallas_advect_pair(jnp.asarray(x[0]), jnp.asarray(a[0]), jb, (0, 1, 2),
                                     limiter, surg, form, interpret=True)
        else:
            ref = sum(pallas_advect_pair(jnp.asarray(x[j]), jnp.asarray(a[j]), jb, (j,), limiter,
                                         surg, form, interpret=True) for j in range(3))
        xt = _t(x)
        at = gamma_from_numpy(a, xt)
        got = pst.apply_div_field(xt, at, pb, limiter, surg, form)
        assert _rel(got[0].numpy(), ref) <= 1e-12, vdim
        before = advect.advect_pair.launches
        assert torch.equal(advect.advect_pair(xt, at, pb, limiter, surg, form), got)
        assert advect.advect_pair.launches == before


@pytest.mark.parametrize("kind", sorted(SURGERY))
@pytest.mark.parametrize("limiter", ["none", "upwind"])
def test_conv_component_vs_jax_pallas_interpret(limiter, kind):
    """``pallas_conv_component`` once per target component, stacked, as
    the JAX operator calls it (``linalg.py:184-195``)."""
    surg = SURGERY[kind]
    jb, pb = _bases(KSHAPE)
    x, a = _inputs(KSHAPE, 2, 3, 60)
    ja = jnp.asarray(a)
    ref = np.stack([np.asarray(pallas_conv_component(jnp.asarray(x[i]), ja, jb, limiter, surg,
                                                     interpret=True)) for i in range(2)])
    xt = _t(x)
    got = pst.apply_conv_field(xt, _t(a), pb, limiter, surg)
    assert _rel(got.numpy(), ref) <= 1e-12
    before = advect.conv_component.launches
    assert torch.equal(advect.conv_component(xt, _t(a), pb, limiter, surg), got)
    assert advect.conv_component.launches == before


@pytest.mark.parametrize("shape", [KSHAPE, (12, 13, 128)], ids=lambda s: "x".join(map(str, s)))
def test_axis_stencil5_vs_jax_pallas_interpret(shape):
    """Axes 0 and 2 of 5 vectors, axis 1 of 3 (zero-padded by the TPU
    kernel's ``_pad5``), as ``tests/test_pallas.py`` mixes them."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1,) + shape)
    cs = _coeffs5(shape, rng, (5, 3, 5))
    ref = pallas_axis_stencil_v5(tuple(tuple(jnp.asarray(c) for c in c3) for c3 in cs),
                                 jnp.asarray(x), interpret=True)
    got = axis_stencil5(tuple(tuple(_t(c) for c in c3) for c3 in cs), _t(x))
    assert _rel(got.numpy(), ref) <= 1e-12


# -- what the wrappers take --------------------------------------------------

def _adv_args(shape=(5, 6, 7), dtype=torch.float64, vdim=1):
    nd = len(shape)
    x = torch.zeros((vdim, *shape), dtype=dtype)
    adv = torch.ones((vdim, *shape), dtype=dtype)
    base = tuple(tuple(torch.full((n,), v, dtype=dtype) for v in (0.5, 0.0, -0.5))
                 for n in shape)
    return x, adv, base, (("none", "none"),) * nd


@pytest.mark.parametrize(
    "case, exc",
    [("float16", TypeError), ("adv_dtype", TypeError), ("4d", ValueError),
     ("2_nodes", ValueError), ("adv_shape", ValueError), ("adv_components", ValueError),
     ("noncontiguous", ValueError), ("base_length", ValueError), ("limiter", ValueError),
     ("form", ValueError), ("surgery", ValueError), ("conv_components", ValueError)],
)
def test_advect_wrappers_reject_what_the_kernel_does_not_take(case, exc):
    """The advection wrappers raise on an unsupported dtype, shape, layout
    or option, on the CPU path as on the card."""
    x, adv, base, surg = _adv_args()
    kw = dict(limiter="upwind", form="conservative")
    if case == "float16":
        x, adv, base, surg = _adv_args(dtype=torch.float16)
    elif case == "adv_dtype":
        adv = adv.float()
    elif case == "4d":
        x, adv, base, surg = _adv_args(shape=(4, 4, 4, 4))
    elif case == "2_nodes":
        x, adv, base, surg = _adv_args(shape=(5, 2, 7))
    elif case == "adv_shape":
        adv = torch.ones((1, 5, 6, 8), dtype=torch.float64)
    elif case == "adv_components":
        x, _, base, surg = _adv_args(vdim=3)
        adv = torch.ones((2, 5, 6, 7), dtype=torch.float64)
    elif case == "noncontiguous":
        adv = torch.ones((1, 7, 6, 5), dtype=torch.float64).transpose(1, 3)
    elif case == "base_length":
        base = base[:2] + (tuple(c[:-1] for c in base[2]),)
    elif case == "limiter":
        kw["limiter"] = "tvd"
    elif case == "form":
        kw["form"] = "skew"
    elif case == "surgery":
        surg = (("dirichlet", "none"),) + surg[1:]
    with pytest.raises(exc):
        if case == "conv_components":
            advect.conv_component(x, adv, base, "none", surg)
        else:
            advect.advect_pair(x, adv, base, kw["limiter"], surg, kw["form"])


def test_axis_stencil_takes_five_point_axes_dot_does_not():
    """The apply hands a 5-point equation to the 5-point kernel; the CG
    alpha-dot kernel takes 3-point axes only."""
    from pyapes_tpu_torch.ops.axis_stencil import check_inputs

    shape = (6, 7, 8)
    cs = _coeffs5(shape, np.random.default_rng(3), (5, 3, 5))
    tc = tuple(tuple(_t(c) for c in c3) for c3 in cs)
    x = torch.zeros((1, *shape), dtype=torch.float64)
    check_inputs(tc, x)
    with pytest.raises(NotImplementedError):
        check_inputs(tc, x, points=(3,))
    with pytest.raises(ValueError):
        check_inputs((tc[0][:4],) + tc[1:], x)
