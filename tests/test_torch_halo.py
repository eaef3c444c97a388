"""The domain-decomposition pieces of the port against the JAX package
(CPU, float64): the halo-extended stencil's plain version against
``pallas_axis_stencil_ext`` in interpret mode, the block-wise stencil and
advection applies against ``make_sharded_pallas_apply`` /
``make_sharded_stencil`` / ``make_sharded_advect_apply`` (8 virtual CPU
devices, conftest), the support gates, the halo exchange and
``DomainDecomposition``.

Tolerances: the stencils sum the same f64 products in the same order, so
they agree to rounding (1e-12); the advection applies to the JAX test's
1e-11 (its per-block kernels and patches reassociate a few products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.ops.pallas_stencil_v3 import pallas_axis_stencil_ext  # noqa: E402
from pyapes_tpu.parallel import DomainDecomposition as JDD  # noqa: E402
from pyapes_tpu.parallel import halo as jhalo  # noqa: E402
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil_ext  # noqa: E402
from pyapes_tpu_torch.ops.stencil import (  # noqa: E402
    _eliminate_boundary_node,
    apply_axis_stencil,
    apply_axis_stencil_ext,
    apply_conv_field,
    apply_div_field,
)
from pyapes_tpu_torch.parallel import DomainDecomposition  # noqa: E402
from pyapes_tpu_torch.parallel import halo  # noqa: E402


def _coeffs(nx, kind, rng):
    """Per-axis (ap, ac, am) numpy vectors: a Laplacian with a Neumann
    elimination on the lower face of axis 0 and the upper face of axis 1,
    or random."""
    out = []
    for j, n in enumerate(nx):
        if kind == "random":
            out.append(tuple(rng.standard_normal(n) for _ in range(3)))
            continue
        inv = float((n - 1) ** 2)
        ap, ac, am = inv * np.ones(n), -2.0 * inv * np.ones(n), inv * np.ones(n)
        if j < 2:
            _eliminate_boundary_node(ap, ac, am, j == 0)
        out.append((ap, ac, am))
    return tuple(out)


def _t(cs):
    return tuple(tuple(torch.from_numpy(c) for c in triple) for triple in cs)


def _j(cs):
    return tuple(tuple(jnp.asarray(c) for c in triple) for triple in cs)


EXT_CASES = [((1, 8 + 2, 16, 128), (1, 0, 0)), ((2, 8 + 2, 8 + 2, 128), (1, 1, 0)),
             ((1, 8, 16 + 2, 128), (0, 1, 0))]


@pytest.mark.parametrize("kind", ["laplacian", "random"])
@pytest.mark.parametrize("case", range(len(EXT_CASES)))
def test_ext_plain_vs_pallas(case, kind):
    shape, ext = EXT_CASES[case]
    rng = np.random.default_rng(case)
    x = rng.standard_normal(shape)
    nx = [s - 2 * e for s, e in zip(shape[1:], ext)]
    cs = _coeffs(nx, kind, rng)
    ref = np.asarray(pallas_axis_stencil_ext(_j(cs), jnp.asarray(x), ext, interpret=True))
    got = apply_axis_stencil_ext(_t(cs), torch.from_numpy(x), ext)
    assert tuple(got.shape) == (shape[0], *nx)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    # the wrapper on a CPU tensor is the plain version, into a strided view too
    big = torch.full((shape[0], nx[0] + 3, nx[1] + 2, nx[2]), 7.0, dtype=torch.float64)
    view = big[:, 1:1 + nx[0], 2:2 + nx[1]]
    assert axis_stencil_ext(_t(cs), torch.from_numpy(x), ext, out=view) is view
    assert torch.equal(view, got) and float(big[:, 0].min()) == 7.0


def test_ext_equals_global_stencil_on_a_torus():
    """With the ghosts taken from the torus, the extended apply is the
    global one, in bf16/f32/f64 (each computed in promote(dtype, f32))."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 6, 7, 9)))
    cs = _t(_coeffs((6, 7, 9), "random", rng))
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        xd, cd = x.to(dt), tuple(tuple(c.to(dt) for c in t) for t in cs)
        xe = torch.cat([xd[:, -1:], xd, xd[:, :1]], dim=1)
        xe = torch.cat([xe[:, :, -1:], xe, xe[:, :, :1]], dim=2).contiguous()
        assert torch.equal(apply_axis_stencil_ext(cd, xe, (1, 1, 0)), apply_axis_stencil(cd, xd))


@pytest.mark.parametrize("case", ["2d", "ext_z", "noncontiguous", "coeff_len", "out_stride",
                                  "float16", "ext_flag"])
def test_ext_wrapper_rejects(case):
    x = torch.zeros((1, 6, 6, 8), dtype=torch.float64)
    cs = tuple(tuple(torch.zeros(n, dtype=torch.float64) for _ in range(3)) for n in (4, 6, 8))
    ext, out, exc = (1, 0, 0), None, ValueError
    if case == "2d":
        x = torch.zeros((1, 6, 8), dtype=torch.float64)
    elif case == "ext_z":
        ext = (1, 0, 1)
    elif case == "noncontiguous":
        x = torch.zeros((1, 8, 6, 6), dtype=torch.float64).transpose(1, 3)
    elif case == "coeff_len":
        cs = (cs[1],) + cs[1:]
    elif case == "out_stride":
        out = torch.zeros((1, 8, 6, 4), dtype=torch.float64).transpose(1, 3)
    elif case == "float16":
        x, exc = x.half(), TypeError
    else:
        ext = (2, 0, 0)
    with pytest.raises(exc):
        axis_stencil_ext(cs, x, ext, out=out)


def _field(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("mesh_shape", [(8, 1, 1), (2, 4, 1), (4, 2, 1), (4, 1)])
def test_sharded_apply_vs_jax(mesh_shape):
    nx = (16, 16, 128) if len(mesh_shape) == 3 else (32, 128)
    rng = np.random.default_rng(len(mesh_shape))
    x = _field((1, *nx), 1)
    cs = _coeffs(nx, "laplacian", rng)
    jdd = JDD(mesh_shape)
    xs = jax.device_put(jnp.asarray(x), jdd.sharding(1 + len(nx)))
    japply = jhalo.make_sharded_pallas_apply(jdd, len(nx), interpret=True)
    ref_pallas = np.asarray(jax.jit(lambda v: japply(_j(cs), v))(xs))
    ref_plain = np.asarray(jhalo.make_sharded_stencil(jdd, _j(cs), 1 + len(nx))(xs))
    glob = apply_axis_stencil(_t(cs), torch.from_numpy(x)).numpy()
    dd = DomainDecomposition(mesh_shape)
    assert halo.sharded_supported(dd, nx)
    got = halo.make_sharded_apply(dd, len(nx))(_t(cs), torch.from_numpy(x)).numpy()
    plain = halo.make_sharded_stencil(dd, _t(cs), 1 + len(nx))(torch.from_numpy(x)).numpy()
    scale = np.abs(glob).max()
    for a, b in ((got, ref_pallas), (got, ref_plain), (plain, ref_plain), (got, glob),
                 (plain, glob)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("mesh_shape, shape", [
    ((8, 1, 1), (16, 16, 128)), ((4, 2, 1), (16, 16, 128)), ((1, 1, 2), (16, 16, 128)),
    ((2, 2, 2), (16, 16, 16)), ((16, 1, 1), (16, 16, 128)), ((3, 1, 1), (16, 16, 128)),
    ((4, 1), (32, 128)), ((2, 4), (32, 128)), ((2, 1), (4, 128)), ((4, 2), (16, 16, 128)),
])
def test_gates_follow_the_jax_rules(mesh_shape, shape):
    """The port's gates are the JAX package's without the TPU tiling
    clauses: both accept or both reject on shapes whose blocks the TPU
    tiling takes (lane axis 128), except the port's 2-D minimum of 3 nodes
    per block, which the (2, 1) case on 4 x 128 pins."""
    dd, jdd = DomainDecomposition(mesh_shape), JDD(mesh_shape)
    ours = halo.sharded_supported(dd, shape)
    theirs = jhalo.sharded_pallas_supported(jdd, shape, jnp.float64)
    if mesh_shape == (2, 1):
        assert not ours
    else:
        assert ours == theirs
    for limiter in ("none", "upwind", "quick"):
        assert (halo.sharded_advect_supported(dd, shape, limiter)
                == jhalo.sharded_advect_supported(jdd, shape, jnp.float64, limiter))


def test_sharded_advect_apply_vs_jax():
    """The ``test_sharded_advect_apply_unit`` cases: every limiter, form
    and vdim with Neumann surgery on the cut axes' global faces."""
    nx = (16, 16, 128)
    rng = np.random.default_rng(3)
    x1, x3 = rng.standard_normal((1, *nx)), rng.standard_normal((3, *nx))
    a1, a3 = rng.standard_normal((1, *nx)), rng.standard_normal((3, *nx))
    base = tuple((0.5 * (n - 1) * np.ones(n), np.zeros(n), -0.5 * (n - 1) * np.ones(n))
                 for n in nx)
    surgery = (("neumann", "none"), ("none", "neumann"), ("none", "none"))
    jdd, dd = JDD((2, 2, 1)), DomainDecomposition((2, 2, 1))
    cases = []
    for limiter in ("none", "upwind"):
        for form in ("conservative", "advective"):
            cases += [("div", x1, a1, limiter, form, 1), ("div", x3, a3, limiter, form, 3)]
        cases.append(("conv", x3, a3, limiter, None, 3))
    for kind, x, a, limiter, form, vdim in cases:
        jfn = jhalo.make_sharded_advect_apply(jdd, kind, vdim, limiter, surgery, form,
                                              interpret=True)
        xs, as_ = (jax.device_put(jnp.asarray(v), jdd.sharding(4)) for v in (x, a))
        ref = np.asarray(jax.jit(lambda u, v: jfn(u, v, _j(base)))(xs, as_))
        fn = halo.make_sharded_advect_apply(dd, kind, vdim, limiter, surgery, form)
        got = fn(torch.from_numpy(x), torch.from_numpy(a), _t(base)).numpy()
        if kind == "div":
            glob = apply_div_field(torch.from_numpy(x), torch.from_numpy(a), _t(base), limiter,
                                   surgery, form).numpy()
        else:
            glob = apply_conv_field(torch.from_numpy(x), torch.from_numpy(a), _t(base), limiter,
                                    surgery).numpy()
        tag = f"{kind}/{limiter}/{form}/vdim{vdim}"
        np.testing.assert_allclose(got, ref, atol=1e-11, err_msg=tag)
        np.testing.assert_allclose(got, glob, atol=1e-11, err_msg=tag)


def test_sharded_advect_periodic_surgery():
    """Rank-gated periodic surgery (a torus seam row on each cut axis'
    global faces): the block-wise apply equals the global one."""
    nx = (12, 9, 10)
    rng = np.random.default_rng(8)
    x, a = torch.from_numpy(rng.standard_normal((1, *nx))), torch.from_numpy(
        rng.standard_normal((1, *nx)))
    base = _t(tuple((0.5 * (n - 1) * np.ones(n), np.zeros(n), -0.5 * (n - 1) * np.ones(n))
                    for n in nx))
    surgery = (("periodic", "neumann"), ("neumann", "periodic"), ("none", "none"))
    for limiter in ("none", "upwind"):
        fn = halo.make_sharded_advect_apply(DomainDecomposition((4, 3, 1)), "div", 1, limiter,
                                            surgery, "conservative")
        np.testing.assert_allclose(
            fn(x, a, base).numpy(),
            apply_div_field(x, a, base, limiter, surgery, "conservative").numpy(), atol=1e-11)


def test_halo_exchange_is_the_ring_neighbours_rows():
    x = torch.arange(2 * 8 * 6, dtype=torch.float64).reshape(2, 8, 6)
    dd = DomainDecomposition((4, 2))
    blocks = dict(dd.blocks((8, 6)))
    lo, hi = halo.halo_exchange(x, blocks[(0, 1)], 0)
    assert torch.equal(lo, x[:, 7:8, 3:6]) and torch.equal(hi, x[:, 2:3, 3:6])  # ring wrap
    lo, hi = halo.halo_exchange(x, blocks[(2, 0)], 1)
    assert torch.equal(lo, x[:, 4:6, 5:6]) and torch.equal(hi, x[:, 4:6, 3:4])
    buffers = {}
    buf = halo.exchange(x[:, :, :].unsqueeze(-1).expand(2, 8, 6, 4).contiguous(),
                        blocks[(1, 0)] + (slice(0, 4),), (1, 1, 0), buffers)
    assert tuple(buf.shape) == (2, 4, 5, 4)
    assert torch.equal(buf[:, 1:3, 1:4, 0], x[:, 2:4, 0:3])
    assert torch.equal(buf[:, 0, 1:4, 0], x[:, 1, 0:3]) and torch.equal(buf[:, 3, 1:4, 0],
                                                                         x[:, 4, 0:3])
    assert torch.equal(buf[:, 1:3, 0, 0], x[:, 2:4, 5]) and torch.equal(buf[:, 1:3, 4, 0],
                                                                        x[:, 2:4, 3])


def test_domain_decomposition():
    dd = DomainDecomposition([4, 2, 1])
    assert dd.mesh_shape == (4, 2, 1) and dd.axis_names == ("sx", "sy", "sz")
    assert dd.n_devices == JDD((4, 2, 1)).n_devices == 8
    blocks = list(dd.blocks((16, 16, 128)))
    assert len(blocks) == 8 and blocks[1] == ((0, 1, 0), (slice(0, 4), slice(8, 16),
                                                          slice(0, 128)))
    assert list(DomainDecomposition((2,)).blocks((4, 3)))[1][1] == (slice(2, 4), slice(0, 3))
    with pytest.raises(ValueError):
        list(dd.blocks((15, 16, 128)))
    assert hash(dd) == hash(DomainDecomposition((4, 2, 1)))
    placed = DomainDecomposition((2, 1), devices=("cpu", "cpu"))
    placed.check_device(torch.device("cpu"))
    assert placed.placed and not dd.placed
    assert [d for _, _, d in placed.placement((4, 3))] == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):  # JAX decomp.py:69-72
        DomainDecomposition((2, 1), devices=("cpu",))
