"""Placed variable-Γ and Div/Conv terms, the Γ-aware multigrid on placed
levels and a placed ``PeriodicFlow`` on the CPU (float64): the five JAX
tests of ``tests/test_sharding.py`` that run these paths, by name, on
``("cpu",) * n`` placed blocks (each block its own allocation), each held
to the view-based port and to the JAX package's decomposed solve on its 8
virtual CPU devices; the placed applies against the whole-array plain
versions; and the placed loops' traffic (no grid-sized allocation, no
gather, ``x``'s ghost faces only, Γ and the advector scattered once per
solve).

The implicit advection solves are BiCGSTAB on a nonsymmetric operator,
300-400 iterations to tol 1e-10: the per-block partial sums of the dots
(another order than a global sum) move their count, as a change of
rounding moves the JAX package's own decomposed count; so these are held
to the JAX test's 2e-7 and no ``itr`` (``test_torch_decomp.py`` holds the
view-based port the same way). The other solves take the view-based
``itr``.
"""
from math import pi

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyapes_tpu.models as jmodels  # noqa: E402
import pyapes_tpu_torch.models as pmodels  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops import stencil as pst  # noqa: E402
from pyapes_tpu_torch.parallel import DomainDecomposition, blocks, halo  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.solver import multigrid  # noqa: E402
from pyapes_tpu_torch.solver.linalg import build as build_mod  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import mixed_bcs  # noqa: E402
from test_torch_decomp import (  # noqa: E402
    JAX,
    PLACED,
    PORT,
    _taylor_green,
    advect,
    stacked_gamma,
    var_gamma,
)
from test_torch_placed import _GlobalAllocations, _ghost_bytes, _placed  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

CPU = torch.device("cpu")


def _three_ways(problem, dd, *args):
    """``problem`` placed, view-based (the port) and JAX-decomposed on the
    decomposition ``dd``, and JAX on one device."""
    return (problem(PLACED, dd, *args), problem(PORT, dd, *args), problem(JAX, dd, *args),
            problem(JAX, None, *args))


@pytest.mark.parametrize("limiter", ["none", "upwind"])
@pytest.mark.parametrize("op", ["div", "conv"])
def test_sharded_advect_matches_single_device(op, limiter, monkeypatch):
    """Implicit Div/Conv with mixed Dirichlet/Neumann faces, BiCGSTAB, on
    placed (2, 2, 1) blocks: the view-based port, the JAX package's
    decomposed (``kernel: "pallas"``, as its test) and single-device solves
    to the JAX test's 2e-7; no gather in the loop."""
    real_solver = JAX.Solver
    monkeypatch.setattr(JAX, "Solver", lambda c: real_solver(
        {"fdm": {**c["fdm"], "kernel": "pallas"} if "decomp" in c["fdm"] else c["fdm"]}))
    g0 = blocks.gathers
    (out, rep), (view, vrep), (jout, jrep), (ref, rref) = _three_ways(advect, (2, 2, 1), limiter,
                                                                       op)
    assert blocks.gathers == g0
    for r in (rep, vrep, jrep, rref):
        assert r["tol"] < 1e-9, r
    for other in (view, jout, ref):
        np.testing.assert_allclose(out, other, atol=2e-7, rtol=0)


def test_sharded_advect_apply_unit():
    """The placed Div/Conv apply equals the whole-array plain versions of
    both packages for every (limiter, form, components) case of the JAX
    test, with its rank-gated Neumann surgery, on (2, 2, 1) blocks, at
    1e-11; each apply moves ``x``'s ghost faces only."""
    from pyapes_tpu.ops import stencil as jst
    import jax.numpy as jnp

    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [16, 16, 128], device="cpu", dtype="double")
    rng = np.random.default_rng(3)
    x1, x3, a1, a3 = (rng.standard_normal((c, 16, 16, 128)) for c in (1, 3, 1, 3))
    base = pst.div_axis_coeffs(mesh, None, 1.0, "none")
    base_t = tuple(tuple(torch.from_numpy(c) for c in cs) for cs in base)
    surgery = (("neumann", "none"), ("none", "neumann"), ("none", "none"))
    dd = _placed((2, 2, 1))
    lay = blocks.layout(dd, (16, 16, 128), CPU)
    cases = []
    for limiter in ("none", "upwind"):
        for form in ("conservative", "advective"):
            cases += [("div", x1, a1, limiter, form, 1), ("div", x3, a3, limiter, form, 3)]
        cases.append(("conv", x3, a3, limiter, "advective", 3))
    for kind, x, a, limiter, form, vdim in cases:
        if kind == "div":
            want = jst.apply_div_field(jnp.asarray(x), jnp.asarray(a), base, limiter, surgery,
                                       form)
            plain = pst.apply_div_field(torch.from_numpy(x), torch.from_numpy(a), base_t,
                                        limiter, surgery, form)
        else:
            want = jst.apply_conv_field(jnp.asarray(x), jnp.asarray(a), base, limiter, surgery)
            plain = pst.apply_conv_field(torch.from_numpy(x), torch.from_numpy(a), base_t,
                                         limiter, surgery)
        fn = halo.make_sharded_advect_apply(dd, kind, vdim, limiter, surgery, form)
        xb = blocks.scatter(torch.from_numpy(x), lay)
        ab = blocks.scatter_operand(torch.from_numpy(a), lay)
        b0, g0 = halo.exchange_bytes, blocks.gathers
        out = fn(xb, ab, base_t)
        assert isinstance(out, blocks.BlockTensor) and blocks.gathers == g0
        assert halo.exchange_bytes - b0 == _ghost_bytes((2, 2, 1), x.shape, 8)
        got = blocks.gather(out, count=False).numpy()
        msg = f"{kind}/{limiter}/{form}/vdim{vdim}"
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-11, rtol=0, err_msg=msg)
        np.testing.assert_allclose(got, plain.numpy(), atol=1e-11, rtol=0, err_msg=msg)


def _held(placed, view, jdec, single, atol):
    (out, rep), (vout, vrep), (jout, jrep), (ref, rref) = placed, view, jdec, single
    assert rep["converge"] and vrep["converge"] and jrep["converge"], (rep, vrep, jrep)
    assert rep["itr"] == vrep["itr"] == jrep["itr"] == rref["itr"], (rep, vrep, jrep, rref)
    np.testing.assert_allclose(out, vout, atol=1e-10, rtol=0)
    for other in (jout, ref):
        np.testing.assert_allclose(out, other, atol=atol, rtol=0)


@pytest.mark.parametrize("ms", [(4, 2), (2, 4)])
def test_sharded_var_gamma_matches_single_device(ms):
    """Variable-Γ CG with the Γ-aware MG on placed blocks: Γ scattered once
    and sampled down the placed levels block by block (the coarsest placed
    level's Γ gathered once per ``set_gamma`` for the levels below), the
    view-based ``itr`` and solution (1e-10: the dots sum per block), the JAX
    decomposed and single-device solves to the JAX test's 1e-8; the
    V-cycle gathers once, at the hand-over to the levels on the lead
    device."""
    v0, c0, g0, s0, gg0 = (multigrid.vcycles, multigrid.cycle_gathers, blocks.gathers,
                           blocks.operand_scatters, multigrid.gamma_gathers)
    placed = var_gamma(PLACED, ms)
    cycles, in_cycles = multigrid.vcycles - v0, multigrid.cycle_gathers - c0
    shapes = multigrid._level_shapes((64, 64))
    n_placed = sum(halo.placed_field_supported(_placed(ms), s) for s in shapes)
    assert 0 < n_placed < len(shapes)
    assert cycles == placed[1]["itr"] + 1 and in_cycles == cycles
    assert multigrid.gamma_gathers - gg0 == 1
    assert blocks.gathers - g0 == in_cycles + 1
    assert blocks.operand_scatters - s0 == 1
    _held(placed, var_gamma(PORT, ms), var_gamma(JAX, ms), var_gamma(JAX, None), 1e-8)


def test_sharded_anisotropic_gamma():
    """Stacked ``(dim, *nx)`` Γ, plain CG on placed (2, 4) blocks: the
    view-based ``itr`` and solution, the JAX solves to 1e-8; no gather."""
    g0 = blocks.gathers
    placed = stacked_gamma(PLACED, (2, 4))
    assert blocks.gathers == g0
    _held(placed, stacked_gamma(PORT, (2, 4)), stacked_gamma(JAX, (2, 4)),
          stacked_gamma(JAX, None), 1e-8)


def test_sharded_periodic_flow_taylor_green():
    """5 Taylor-Green steps of ``PeriodicFlow`` on placed (2, 4) blocks (the
    placed fastdiag momentum and singular pressure): the view-based run's
    ``itr`` per solve and fields (1e-12), the JAX package's decomposed and
    single-device runs to the JAX test's 1e-9 with the same passes."""
    placed = _taylor_green(PLACED, pmodels, (2, 4))
    view = _taylor_green(PORT, pmodels, (2, 4))
    jdec = _taylor_green(JAX, jmodels, (2, 4))
    jref = _taylor_green(JAX, jmodels, None)
    assert placed[3] == view[3] == jdec[3] == jref[3] and len(placed[3]) == 15
    for a, b, c, d, name in zip(placed[:3], view[:3], jdec[:3], jref[:3], ("u", "v", "p")):
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=0, err_msg=name)
        np.testing.assert_allclose(a, c, atol=1e-9, rtol=1e-9, err_msg=name)
        np.testing.assert_allclose(a, d, atol=1e-9, rtol=1e-9, err_msg=name)


# -- the placed variable-Γ apply and pass against the whole-array plain versions


def _gamma(rng, shape, stacked):
    g = 0.5 + rng.random(((len(shape),) if stacked else ()) + tuple(shape))
    return torch.from_numpy(g)


FIELD_CASES = [  # (grid, blocks, surgery, periodic axes)
    ((16, 12, 10), (4, 2, 1), (("neumann", "none"), ("none", "neumann"), ("none", "none")), ()),
    ((12, 16, 9), (2, 2, 1), (("none", "none"), ("neumann", "neumann"), ("neumann", "none")),
     ()),
    ((16, 8, 10), (4, 2, 1), (("none", "none"), ("none", "none"), ("neumann", "none")), (0, 1)),
    ((24, 18), (4, 2), (("neumann", "neumann"), ("none", "neumann")), ()),
    ((16, 12), (2, 4), (("none", "none"), ("neumann", "none")), (0,)),
    ((12, 9, 8), (3, 1, 2), (("neumann", "none"), ("none", "none"), ("none", "neumann")), ()),
]


def _face_rows(shape, lay, wrap):
    """A mask of the rows the solver keeps: every row but the end rows of a
    cut axis that is not periodic (their output is what the solver's mask
    discards; the single-device torus kernel leaves wrap values there)."""
    keep = torch.ones(shape, dtype=torch.bool)
    for j in range(len(shape) - 1):
        if lay.cut[j] and j not in wrap:
            idx = [slice(None)] * len(shape)
            idx[1 + j] = [0, shape[1 + j] - 1]
            keep[tuple(idx)] = False
    return keep


@pytest.mark.parametrize("avg", ["arithmetic", "harmonic"])
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("case", range(len(FIELD_CASES)))
def test_placed_diff_field_and_jacobi_equal_the_plain_versions(case, stacked, avg):
    """``halo.placed_diff_field`` (on the rows the solver keeps) and
    ``placed_diff_jacobi`` in its three modes (on every row: the end rows are
    masked) equal ``apply_diff_field`` / ``apply_diff_jacobi`` of the whole
    array at 1e-12; Neumann faces on the edge blocks; periodic axes as the
    torus; the ghost faces of ``x`` the only bytes an apply moves."""
    nx, ms, surgery, wrap = FIELD_CASES[case]
    rng = np.random.default_rng(case)
    x = torch.from_numpy(rng.standard_normal((2, *nx)))
    b = torch.from_numpy(rng.standard_normal((2, *nx)))
    g = _gamma(rng, nx, stacked)
    inv = [float(n - 1) ** 2 for n in nx]
    dd = _placed(ms)
    assert halo.placed_field_supported(dd, nx, wrap)
    lay = blocks.layout(dd, nx, CPU)
    xb, bb = blocks.scatter(x, lay), blocks.scatter(b, lay)
    gb = blocks.scatter_operand(g, lay)
    buffers: dict = {}
    b0, g0 = halo.exchange_bytes, blocks.gathers
    out = halo.placed_diff_field(xb, gb, inv, surgery, avg, wrap, buffers)
    assert halo.exchange_bytes - b0 == halo.field_ghost_bytes(lay, 2, 8, wrap)
    got = blocks.gather(out, count=False)
    want = pst.apply_diff_field(x, g, inv, surgery, avg)
    keep = _face_rows(x.shape, lay, wrap)
    np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(), atol=1e-12, rtol=0)
    mask_axes = tuple(j for j in range(len(nx)) if j not in wrap)
    for mode in ("smooth", "smooth0", "resid"):
        xin = None if mode == "smooth0" else xb
        got = blocks.gather(halo.placed_diff_jacobi(xin, bb, gb, inv, surgery, avg, 0.8,
                                                    mask_axes, mode, buffers), count=False)
        want = pst.apply_diff_jacobi(None if mode == "smooth0" else x, b, g, inv, surgery, avg,
                                     0.8, mask_axes, mode)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12, rtol=0, err_msg=mode)
    assert blocks.gathers == g0


def test_field_gate_rejects_what_the_kernel_rejects():
    """The variable-Γ gate wants 3 nodes per buffer axis: 2 nodes per block
    on a cut axis take one ghost row (3); 1 node per block does not, and
    reaches 3 only on a periodic axis (both ghost rows); an uncut axis
    needs its 3 nodes itself."""
    assert halo.placed_field_supported(_placed((4, 1)), (8, 8))
    assert not halo.placed_field_supported(_placed((4, 1)), (4, 8))
    assert halo.placed_field_supported(_placed((4, 1)), (4, 8), wrap=(0,))
    assert halo.placed_field_supported(_placed((2, 1, 1)), (2, 5, 5), wrap=(0,))
    assert not halo.placed_field_supported(_placed((2, 1)), (8, 2), wrap=(1,))
    assert not halo.placed_field_supported(_placed((2, 1, 1)), (2, 5, 5))
    assert not halo.placed_field_supported(_placed((2, 1, 1)), (7, 5, 5))


# -- the placed loops' traffic


def _vg_problem(nx, seed, kinds=None, stacked=False):
    mesh = Mesh(Box[(slice(0, 1),) * len(nx)], None, list(nx), device="cpu", dtype="double")
    kinds = kinds or ["dirichlet"] * (2 * len(nx))
    var = Field("p", 1, mesh, {"domain": mixed_bcs([0.0] * len(kinds), kinds),
                               "obstacle": None}, init_val=0.0)
    rng = np.random.default_rng(seed)
    rhs = torch.from_numpy(rng.standard_normal((1, *nx)))
    g = _gamma(rng, nx, stacked)
    return var, rhs, FDM().laplacian(tuple(g) if stacked else g, var)


def _adv_problem(nx, seed, op, limiter):
    mesh = Mesh(Box[(slice(0, 1),) * len(nx)], None, list(nx), device="cpu", dtype="double")
    kinds = ["dirichlet", "neumann", "dirichlet", "dirichlet", "neumann", "dirichlet"]
    var = Field("p", 1, mesh, {"domain": mixed_bcs([0.0] * 6, kinds), "obstacle": None},
                init_val=0.0)
    rng = np.random.default_rng(seed)
    rhs = torch.from_numpy(rng.standard_normal((1, *nx)))
    adv = torch.from_numpy(rng.standard_normal(((3 if op == "conv" else 1), *nx)))
    fdm = FDM({"div": {"limiter": limiter, "edge": False}})
    term = fdm.conv(adv, var) if op == "conv" else fdm.div(adv, var)
    return var, rhs, term - fdm.laplacian(1.0, var)


LOOP_CASES = {  # (problem, config, blocks, operands scattered per solve)
    "var_gamma_cg": (lambda: _vg_problem((16, 16, 12), 1, ["neumann"] + ["dirichlet"] * 5),
                     {"method": "cg"}, (4, 2, 1), 1),
    "stacked_gamma_bicgstab": (lambda: _vg_problem((16, 12), 2, stacked=True),
                               {"method": "bicgstab"}, (2, 4), 1),
    "div_central_bicgstab": (lambda: _adv_problem((16, 16, 12), 3, "div", "none"),
                             {"method": "bicgstab"}, (4, 2, 1), 1),
    "conv_upwind_bicgstab": (lambda: _adv_problem((16, 16, 12), 4, "conv", "upwind"),
                             {"method": "bicgstab"}, (2, 2, 1), 1),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_placed_terms_loop_allocates_nothing_global_and_gathers_nothing(case, monkeypatch):
    """Between the scatter and the gather, a placed CG or BiCGSTAB solve with
    a variable-Γ or a Div/Conv term allocates no tensor of the global size
    and gathers nothing; Γ or the advector is scattered once per solve; the
    solve equals the view-based one after the same 12 passes (1e-12)."""
    problem, cfg, ms, n_ops = LOOP_CASES[case]
    modes = []
    name = "build_cg" if cfg["method"] == "cg" else "build_bicgstab"
    real = getattr(build_mod, name)

    def counted_build(*a, **k):
        fn = real(*a, **k)

        def run(x0, rhs, *rest, **kw):
            mode = _GlobalAllocations(x0.numel())
            modes.append(mode)
            with mode:
                return fn(x0, rhs, *rest, **kw)

        return run

    cfg = {**cfg, "tol": 1e-10, "max_it": 12, "criterion": "residual", "report": False}
    outs = []
    for decomp in (_placed(ms), DomainDecomposition(ms)):
        var, rhs, lhs = problem()
        if decomp.placed:
            monkeypatch.setattr(build_mod, name, counted_build)
        g0, s0 = blocks.gathers, blocks.operand_scatters
        s = Solver({"fdm": {**cfg, "decomp": decomp}})
        s.set_eq(lhs == rhs)
        rep = s.solve()
        if decomp.placed:
            monkeypatch.undo()
            assert len(modes) == 1 and modes[0].hits == []
            assert blocks.gathers == g0 and blocks.operand_scatters - s0 == n_ops
        outs.append((var()[0].clone(), rep))
    (out, rep), (ref, rref) = outs
    assert rep["itr"] == rref["itr"] == 12
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-12, rtol=0)


@pytest.mark.parametrize("op", ["div", "conv"])
def test_quick_stays_on_the_lead_device_through_one_counted_gather(op):
    """QUICK's +-2 reach is outside the placed Div/Conv apply: each apply of
    the term gathers ``x`` once on the lead device (its advector's lead copy
    beside it, no second gather) and the solve equals the view-based one."""
    from pyapes_tpu_torch.ops import advect as adv_mod

    calls = []
    real = {k: getattr(adv_mod, k) for k in ("advect_pair", "conv_component")}
    outs = []
    for decomp in (_placed((2, 2, 1)), DomainDecomposition((2, 2, 1))):
        var, rhs, lhs = _adv_problem((16, 16, 12), 5, op, "quick")
        s = Solver({"fdm": {"method": "bicgstab", "tol": 1e-10, "max_it": 8,
                            "criterion": "residual", "report": False, "decomp": decomp}})
        s.set_eq(lhs == rhs)
        g0, a0 = blocks.gathers, halo.placed_applies
        if decomp.placed:
            for k, fn in real.items():
                def counted(*a, fn=fn, **kw):
                    calls.append(a[0].shape)
                    return fn(*a, **kw)
                setattr(build_mod, k, counted)
        try:
            rep = s.solve()
        finally:
            for k, fn in real.items():
                setattr(build_mod, k, fn)
        if decomp.placed:
            # one apply of the operator per pass besides two at entry
            assert len(calls) >= 2 * rep["itr"] and blocks.gathers - g0 == len(calls)
            assert halo.placed_applies - a0 == len(calls)  # the Laplacian, block by block
        outs.append(var()[0].clone())
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-12, rtol=0)


def test_placed_les_matches_the_view_based_run():
    """3 steps of the Smagorinsky TGV-3D LES (17^3, 16^3 on the torus, f64)
    on placed (2, 2, 1) blocks: the momentum's per-point viscosity scattered
    at each momentum solve (9), no gather, the view-based and the
    undecomposed runs' ``itr`` per solve and fields (1e-12)."""
    from pyapes_tpu_torch.models import PeriodicFlow, smagorinsky_viscosity

    def run(decomp):
        L, nu = 2 * pi, 1.0 / 1600.0
        mesh = Mesh(Box[0:L, 0:L, 0:L], None, [17] * 3, device="cpu", dtype="double")
        model = PeriodicFlow(mesh, nu=nu, config={} if decomp is None else {"decomp": decomp},
                             mu_strain_fn=smagorinsky_viscosity(nu, mesh, cs=0.17))
        X, Y, Z = mesh.X, mesh.Y, mesh.Z
        model.set_velocity(torch.sin(X) * torch.cos(Y) * torch.cos(Z),
                           -torch.cos(X) * torch.sin(Y) * torch.cos(Z), torch.zeros_like(X))
        itr = []
        for solver in (model.mom_solver, model.p_solver):
            real = solver.solve

            def solve(real=real):
                rep = real()
                itr.append(rep["itr"])
                return rep

            solver.solve = solve
        model.run(0.2 * L / 16, 3)
        return itr, [f().clone() for f in model.state_fields()]

    g0, s0 = blocks.gathers, blocks.operand_scatters
    placed = run(_placed((2, 2, 1)))
    assert blocks.gathers == g0 and blocks.operand_scatters - s0 == 9
    for other in (run(DomainDecomposition((2, 2, 1))), run(None)):
        assert placed[0] == other[0]
        for a, b in zip(placed[1], other[1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12, rtol=0)
