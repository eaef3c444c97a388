"""The Rosenbluth–Fokker–Planck stack of the port against the JAX package
(CPU, float64):

(a) the operators (``solver/rfp.py``): friction, diffusion, the MUSCL
    drift with both limiters, the limiters and the FD hint within 1e-12 of
    the JAX package's on the same inputs; the goldens of the original
    torch reference (``rfp_*``, 1e-12);
(b) ``fdm.custom``: the implicit RFP step with and without the hint
    (``precond`` "fd" / "none"): the same iterations on every solve,
    fields within 1e-10; the eigen-factors reused by the hint's content;
(c) ``RosenbluthPotentials``: under ``{"method": "bicgstab", "precond":
    "mg"}``, which both packages resolve alike, the same iterations and
    1e-10; under the default config (the port's fastdiag, the JAX
    package's BiCGSTAB + MG fallback) within ``DEFAULT_REL`` of the
    maximum;
(d) ``RFPEvolution.run`` in the three schemes and ``run_selfconsistent``
    (1e-10), from a state carried over (``utils/carry.py``);
(e) the ``rfp`` runner with ``--device cpu``;
(f) the physical gates of the JAX tests (``test_rosenbluth.py``,
    ``test_muscl.py``, ``test_models.py``'s implicit RFP tests) on the port.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyapes_tpu.models as jmodels  # noqa: E402
from pyapes_tpu import runner as jrunner  # noqa: E402
from pyapes_tpu.geometry import Cylinder as JCylinder  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.solver import ops as jops  # noqa: E402
from pyapes_tpu.solver import rfp as jrfp  # noqa: E402
from pyapes_tpu.solver.fdc import hessian as jhessian, jacobian as jjacobian  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
import pyapes_tpu_torch.models as pmodels  # noqa: E402
from pyapes_tpu_torch import runner as prunner  # noqa: E402
from pyapes_tpu_torch.geometry import Box, Cylinder  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.models.rosenbluth import maxwellian_H  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.solver import ops as pops  # noqa: E402
from pyapes_tpu_torch.solver import rfp as prfp  # noqa: E402
from pyapes_tpu_torch.solver.fdc import hessian, jacobian  # noqa: E402
from pyapes_tpu_torch.solver.linalg import build as build_mod  # noqa: E402
from pyapes_tpu_torch.utils.carry import rfp_state_from_numpy  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import homogeneous_bcs  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

TOL = 1e-12
SOLVE_TOL = 1e-10
DEFAULT_REL = 1e-7  # potentials: fastdiag (port) vs BiCGSTAB + MG (JAX), tol 1e-8


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _meshes(bounds, nx):
    (r0, r1), (z0, z1) = bounds
    return (JMesh(JCylinder[r0:r1, z0:z1], None, list(nx), dtype="double"),
            Mesh(Cylinder[r0:r1, z0:z1], None, list(nx), device="cpu", dtype="double"))


def _smooth_state(pm):
    """``test_models.py``'s implicit-RFP state: a Maxwellian-like f and
    smooth monopole-like potentials."""
    R, Z = pm._grid_np
    f0 = np.exp(-(R**2 + Z**2) / (2 * 0.8**2))
    return f0, -np.sqrt(R**2 + Z**2 + 0.5), np.sqrt(R**2 + Z**2 + 0.5)


def _jfield(jm, v):
    f = JField("pdf", 1, jm, None)
    f.set_var_tensor(jnp.asarray(v))
    return f


def _pfield(pm, v):
    return Field("pdf", 1, pm, None).set_var_tensor(v)


# -- (a) operators -----------------------------------------------------------
@pytest.mark.parametrize("bounds, nx", [(((0, 2), (-2, 2)), (33, 33)),
                                        (((0, 3), (-3, 5)), (16, 40)),
                                        (((0.5, 2), (-1, 1)), (12, 9))])
def test_rfp_operators_match_jax(bounds, nx):
    jm, pm = _meshes(bounds, nx)
    rng = np.random.default_rng(nx[0])
    H, G, f = (rng.standard_normal(nx) for _ in range(3))
    jjac, jhess = jjacobian(_jfield(jm, H)), jhessian(_jfield(jm, G))
    pjac, phess = jacobian(_pfield(pm, H)), hessian(_pfield(pm, G))
    jf, pf = _jfield(jm, f[None]), _pfield(pm, f[None])
    _close(prfp.RFP().friction(pjac, pf), jrfp.RFP().friction(jjac, jf))
    _close(prfp.RFP().diffusion(phess, pf), jrfp.RFP().diffusion(jhess, jf))
    for lim in ("mc", "minmod"):
        _close(prfp.friction_apply_muscl(pjac.r, pjac.z, pf()[0], pm, limiter=lim),
               jrfp.friction_apply_muscl(jjac.r, jjac.z, jf()[0], jm, limiter=lim))
    a, b = rng.standard_normal((2, 50))
    for fn in ("minmod", "mc_limiter"):
        _close(getattr(prfp, fn)(torch.from_numpy(a), torch.from_numpy(b)),
               getattr(jrfp, fn)(jnp.asarray(a), jnp.asarray(b)), 0.0)
    for hp, hj in zip(prfp.rfp_fd_hint(phess.rr, phess.zz, pm),
                      jrfp.rfp_fd_hint(jhess.rr, jhess.zz, jm)):
        for a_, b_ in zip(hp, hj):
            _close(a_, b_, 0.0)


def test_rfp_operators_reject_cartesian():
    mesh = Mesh(Box[0:1, 0:1], None, [5, 5], device="cpu", dtype="double")
    f = Field("f", 1, mesh, None)
    jac = jacobian(f)
    with pytest.raises(NotImplementedError):
        prfp.RFP().friction(jac, f)
    with pytest.raises(NotImplementedError):
        prfp.RFP().diffusion(hessian(f), f)


def test_golden_rfp_operators():
    """``tests/test_reference_parity.py::test_parity_rfp_operators``."""
    golden = np.load(os.path.join(os.path.dirname(__file__), "data", "parity_golden.npz"))
    mesh = Mesh(Cylinder[0:2, -2:2], None, [33, 33], device="cpu", dtype="double")
    R, Z = mesh._grid_np
    pdf = _pfield(mesh, np.exp(-(R**2) / 2 - Z**2 / 2))
    jacH = jacobian(_pfield(mesh, np.cos(R) * np.exp(-(Z**2) / 2)))
    hessG = hessian(_pfield(mesh, np.exp(-(R**2) / 4 - Z**2 / 4)))
    np.testing.assert_allclose(_np(jacH.r), golden["rfp_jac_r"], atol=1e-12)
    np.testing.assert_allclose(_np(jacH.z), golden["rfp_jac_z"], atol=1e-12)
    np.testing.assert_allclose(_np(prfp.RFP().friction(jacH, pdf)), golden["rfp_friction"],
                               atol=1e-12)
    np.testing.assert_allclose(_np(prfp.RFP().diffusion(hessG, pdf)), golden["rfp_diffusion"],
                               atol=1e-12)


# -- (b) fdm.custom and the implicit step --------------------------------------
def _spy(mod, out):
    orig = mod.Solver.solve

    def solve(self):
        rep = orig(self)
        out.append(int(self.report["itr"]))
        return rep

    mod.Solver.solve = solve
    return orig


@pytest.mark.parametrize("cfg", [None, {"precond": "none"}, {"precond": "fd", "tol": 1e-11}],
                         ids=["fd_hint", "none", "fd_tight"])
def test_step_implicit_same_solves_as_jax(cfg):
    """``fdm.custom`` with the hint (the default, FD-preconditioned
    BiCGSTAB) and without it: the same iterations on every step, fields
    within 1e-10."""
    jm, pm = _meshes(((0, 3), (-3, 3)), (32, 48))
    f0, H, G = _smooth_state(pm)
    ij, ip = [], []
    oj, op = _spy(jops, ij), _spy(pops, ip)
    try:
        jmod, pmod = jmodels.RFPEvolution(jm, H, G), pmodels.RFPEvolution(pm, H, G)
        fj, fp = _jfield(jm, f0), _pfield(pm, f0)
        for _ in range(3):
            fj = jmod.step_implicit(fj, 2e-3, config=cfg)
            fp = pmod.step_implicit(fp, 2e-3, config=cfg)
    finally:
        jops.Solver.solve, pops.Solver.solve = oj, op
    assert ip == ij and len(ip) == 3, (ip, ij)
    assert pmod.report["converge"]
    _close(fp(), fj(), SOLVE_TOL)
    assert fp.t == pytest.approx(6e-3)


def test_step_implicit_reuses_the_eigen_factors(monkeypatch):
    """A second ``step_implicit`` with the same potentials keys the FD
    eigen-factors by the hint's content and builds no new ``FastDiag``;
    new potentials build one."""
    _, pm = _meshes(((0, 3), (-3, 3)), (16, 24))
    f0, H, G = _smooth_state(pm)
    built = []
    real = build_mod.FastDiag

    def counting(*args, **kwargs):
        built.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(build_mod, "FastDiag", counting)
    build_mod._FD_CACHE.clear()
    model = pmodels.RFPEvolution(pm, H, G)
    f = _pfield(pm, f0)
    model.step_implicit(f, 1e-3)
    assert len(built) == 1
    for _ in range(2):
        model.step_implicit(f, 1e-3)
    assert len(built) == 1
    model.set_potentials(torch.from_numpy(1.1 * H), torch.from_numpy(1.1 * G))
    model.step_implicit(f, 1e-3)
    assert len(built) == 2


def test_custom_term_solve_matches_jax():
    """A bare ``fdm.custom`` term with tensor ``params`` (passed as they
    are) plus ddt, FD-preconditioned through its hint, and without."""
    from pyapes_tpu.solver.fdm import FDM as JFDM
    from pyapes_tpu.solver.ops import Solver as JSolver

    jm, pm = _meshes(((0, 1), (0, 2)), (9, 13))
    rng = np.random.default_rng(6)
    w, x0 = rng.random((9, 13)) + 0.5, rng.standard_normal((1, 9, 13))
    tw = torch.from_numpy(w)
    seen = []

    def pfn(x, c):
        seen.append(c is tw)
        return c * x - 0.1 * (torch.roll(x, 1, 1) + torch.roll(x, -1, 1))

    def jfn(x, c):
        return c * x - 0.1 * (jnp.roll(x, 1, 1) + jnp.roll(x, -1, 1))

    ones = tuple(tuple(np.full(n, v) for v in (0.0, 1.0, 0.0)) for n in (9, 13))
    for cfg, hint in (({"precond": "fd"}, ones), ({"precond": "none"}, None), ({}, None)):
        cfg = {"method": "bicgstab", "tol": 1e-12, "max_it": 200, **cfg}
        jv, pv = _jfield(jm, x0), _pfield(pm, x0)
        for v in (jv, pv):
            v.set_time(0.5, 0.0)
            v.save_old()
        js, ps = JSolver({"fdm": dict(cfg)}), Solver({"fdm": dict(cfg)})
        js.set_eq(JFDM().ddt(jv) + JFDM().custom(jfn, jv, params=(jnp.asarray(w),), fd_hint=hint)
                  == jnp.zeros((1, 9, 13)))
        ps.set_eq(FDM().ddt(pv) + FDM().custom(pfn, pv, params=(tw,), fd_hint=hint)
                  == torch.zeros(1, 9, 13, dtype=torch.float64))
        rj, rp = js.solve(), ps.solve()
        assert rp["itr"] == rj["itr"] and rp["converge"], (cfg, rp, rj)
        _close(pv(), jv(), SOLVE_TOL)
    assert seen and all(seen)


def test_custom_term_on_a_periodic_axis_raises():
    mesh = Mesh(Box[0:1, 0:1], None, [6, 6], device="cpu", dtype="double")
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(2, None, "periodic")})
    s = Solver({"fdm": {"method": "bicgstab", "tol": 1e-8, "max_it": 10}})
    s.set_eq(FDM().custom(lambda x: 2.0 * x, var) == torch.ones(1, 6, 6, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="periodic"):
        s.solve()


# -- (c) RosenbluthPotentials --------------------------------------------------
def _maxwellian(pm, vth):
    R, Z = pm._grid_np
    return np.exp(-(R**2 + Z**2) / (2 * vth**2)) / ((2 * np.pi * vth**2) ** 1.5)


@pytest.mark.parametrize("shape", [(17, 33), (24, 40)])
def test_potentials_same_solves_as_jax(shape):
    """Under ``{"method": "bicgstab", "precond": "mg"}`` (BiCGSTAB with the
    rz V-cycle in both packages): the moments, the same iterations on the
    H and G solves, and H, G within 1e-10."""
    jm, pm = _meshes(((0, 4), (-4, 4)), shape)
    f0 = _maxwellian(pm, 0.8)
    cfg = {"method": "bicgstab", "precond": "mg"}
    jp, pp = (jmodels.RosenbluthPotentials(jm, f0, cfg),
              pmodels.RosenbluthPotentials(pm, torch.from_numpy(f0), cfg))
    assert pp.N == jp.N and pp.z_mean == jp.z_mean
    Hj, Gj = jp.solve(jnp.asarray(f0))
    Hp, Gp = pp.solve(f0)
    rh, rg = pp.reports
    assert rh["itr"] == jp._solver_h.report["itr"] and rg["itr"] == jp._solver_g.report["itr"]
    assert rh["converge"] and rg["converge"]
    _close(Hp, Hj, SOLVE_TOL)
    _close(Gp, Gj, SOLVE_TOL)


def test_potentials_default_config_within_bound():
    """The default config: the port's fastdiag direct solve against the
    JAX package's BiCGSTAB + MG fallback, both at tol 1e-8 (true residual):
    H and G agree within ``DEFAULT_REL`` of their maxima."""
    jm, pm = _meshes(((0, 4), (-4, 4)), (24, 48))
    f0 = _maxwellian(pm, 0.8)
    jp, pp = jmodels.RosenbluthPotentials(jm, f0), pmodels.RosenbluthPotentials(pm, f0)
    Hj, Gj = jp.solve(jnp.asarray(f0))
    Hp, Gp = pp.solve(f0)
    assert all(r["converge"] and r["itr"] <= 2 for r in pp.reports), pp.reports
    for a, b in ((Hp, Hj), (Gp, Gj)):
        assert np.abs(_np(a) - _np(b)).max() <= DEFAULT_REL * np.abs(_np(b)).max()


# -- (d) RFPEvolution -----------------------------------------------------------
@pytest.mark.parametrize("scheme", ["central", "muscl", "minmod"])
def test_run_matches_jax(scheme):
    jm, pm = _meshes(((0, 2), (-4, 4)), (32, 48))
    f0, H, G = _smooth_state(pm)
    jmod = jmodels.RFPEvolution(jm, H, G, scheme=scheme)
    pmod = pmodels.RFPEvolution(pm, torch.from_numpy(H), torch.from_numpy(G), scheme=scheme)
    fj = jmod.run(_jfield(jm, f0), dt=2e-4, n_steps=20)
    fp = pmod.run(_pfield(pm, f0), dt=2e-4, n_steps=20)
    _close(fp(), fj(), TOL)
    _close(pmod.rhs(fp), jmod.rhs(fj), TOL)


@pytest.mark.parametrize("scheme", ["central", "muscl", "minmod"])
def test_run_selfconsistent_matches_jax(scheme):
    """Self-consistent evolution with the potentials' shared config: the
    same solves, fields within 1e-10 after three refreshes."""
    jm, pm = _meshes(((0, 4.5), (-4.5, 4.5)), (20, 40))
    R, Z = pm._grid_np
    f0 = np.exp(-(R**2) / (2 * 0.36) - Z**2 / 2.0)
    cfg = {"method": "bicgstab", "precond": "mg"}
    ij, ip = [], []
    oj, op = _spy(jops, ij), _spy(pops, ip)
    try:
        fj = jmodels.RFPEvolution(jm, scheme=scheme).run_selfconsistent(
            _jfield(jm, f0), dt=4e-4, n_steps=12, refresh_every=4, config=cfg)
        fp = pmodels.RFPEvolution(pm, scheme=scheme).run_selfconsistent(
            _pfield(pm, f0), dt=4e-4, n_steps=12, refresh_every=4, config=cfg)
    finally:
        jops.Solver.solve, pops.Solver.solve = oj, op
    assert ip == ij and len(ip) == 6, (ip, ij)
    _close(fp(), fj(), SOLVE_TOL)


def test_run_selfconsistent_warns_above_the_stability_estimate():
    _, pm = _meshes(((0, 4), (-4, 4)), (12, 24))
    with pytest.warns(UserWarning, match="stability"):
        pmodels.RFPEvolution(pm).run_selfconsistent(_pfield(pm, _maxwellian(pm, 0.8)),
                                                   dt=1.0, n_steps=1)


def test_carried_state_steps_like_jax():
    """A mid-run state of the JAX model (pdf, H, G, and its jacH / hessG),
    carried over as numpy, steps implicitly to the same result."""
    jm, pm = _meshes(((0, 3), (-3, 3)), (24, 32))
    f0, H, G = _smooth_state(pm)
    jmod = jmodels.RFPEvolution(jm, H, G)
    fj = jmod.run(_jfield(jm, f0), dt=2e-4, n_steps=5)
    state = dict(pdf=np.asarray(fj()), H=H, G=G,
                 jac_h={k: np.asarray(jmod.jacH[k]) for k in ("r", "z")},
                 hess_g={k: np.asarray(jmod.hessG[k]) for k in ("rr", "rz", "zz")})
    pmod, fp = rfp_state_from_numpy(pmodels.RFPEvolution(pm), **state)
    for k in ("r", "z"):
        _close(pmod.jacH[k], jmod.jacH[k], 0.0)
    for _ in range(2):
        fj = jmod.step_implicit(fj, 1e-3)
        fp = pmod.step_implicit(fp, 1e-3)
    _close(fp(), fj(), SOLVE_TOL)
    pmod2, _ = rfp_state_from_numpy(pmodels.RFPEvolution(pm), H=H, G=G)
    for k in ("rr", "rz", "zz"):
        _close(pmod2.hessG[k], jmod.hessG[k], TOL)


# -- (e) the runner ---------------------------------------------------------------
def test_runner_rfp_matches_jax():
    argv = ["rfp", "--n", "12", "--steps", "8", "--refresh", "4", "--dt", "2e-4",
            "--dtype", "double"]
    out_p = prunner.run(argv + ["--device", "cpu"])
    import contextlib
    import io
    import json

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jrunner.main(argv)
    out_j = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out_p["steps"] == out_j["steps"] == 8
    assert np.isfinite(out_p["wall_s"])
    assert out_p["density_drift"] == pytest.approx(out_j["density_drift"], rel=1e-3, abs=1e-9)


# -- (f) the JAX tests' gates on the port -------------------------------------------
def _moments(pm, f):
    R, Z = pm._grid_np
    dr, dz = (float(d) for d in pm.dx_np)
    w = 2.0 * np.pi * R * dr * dz
    f = _np(f)
    N = (f * w).sum()
    return N, (f * R**2 * w).sum() / N / 2.0, (f * Z**2 * w).sum() / N


def test_maxwellian_potentials_match_analytic():
    mesh = Mesh(Cylinder[0:4, -4:4], None, [48, 96], device="cpu", dtype="double")
    vth = 0.8
    f0 = _maxwellian(mesh, vth)
    pots = pmodels.RosenbluthPotentials(mesh, f0)
    assert abs(pots.N - 1.0) < 2e-3
    H, G = pots.solve(torch.from_numpy(f0))
    assert all(r["converge"] for r in pots.reports)
    Ha = maxwellian_H(mesh, pots.N, vth)
    assert (np.abs(_np(H) - Ha) / np.abs(Ha).max()).max() < 0.01
    assert abs(_np(G)[-1, 48] - pots.N * 4.0) / (pots.N * 4.0) < 0.01


def test_selfconsistent_relaxation_isotropizes():
    mesh = Mesh(Cylinder[0:4.5, -4.5:4.5], None, [40, 80], device="cpu", dtype="double")
    R, Z = mesh._grid_np
    t_perp0, t_par0 = 0.36, 1.0
    f0 = np.exp(-(R**2) / (2 * t_perp0) - Z**2 / (2 * t_par0))
    f0 /= (2 * np.pi * t_perp0) * np.sqrt(2 * np.pi * t_par0)
    f = _pfield(mesh, f0)
    N0, tp0, tz0 = _moments(mesh, f()[0])
    f = pmodels.RFPEvolution(mesh).run_selfconsistent(f, dt=4e-4, n_steps=300,
                                                      refresh_every=50)
    v = _np(f()[0])
    assert np.all(np.isfinite(v))
    N1, tp1, tz1 = _moments(mesh, v)
    assert abs(N1 - N0) / N0 < 5e-3
    assert abs(tz1 - tp1) < 0.95 * abs(tz0 - tp0)
    assert tp0 - 1e-3 < tp1 < tz1 < tz0 + 1e-3


def test_selfconsistent_maxwellian_is_steady():
    mesh = Mesh(Cylinder[0:3.2, -3.2:3.2], None, [40, 80], device="cpu", dtype="double")
    f0 = _maxwellian(mesh, 0.8)
    f = pmodels.RFPEvolution(mesh).run_selfconsistent(_pfield(mesh, f0), dt=2e-4, n_steps=50,
                                                      refresh_every=25)
    assert np.abs(_np(f()[0]) - f0).max() / f0.max() < 5e-3


def _advect(mesh, f0, v0, dt, n_steps, scheme, rk2=False):
    """``test_muscl.py``'s pure z-drift (H = -v0 z)."""
    Hr = torch.zeros(mesh.nx, dtype=f0.dtype)
    Hz = torch.full(mesh.nx, -v0, dtype=f0.dtype)

    def L(f):
        if scheme == "central":
            return -prfp.friction_apply(Hr, Hz, f, mesh)
        return -prfp.friction_apply_muscl(Hr, Hz, f, mesh, limiter=scheme)

    f = f0
    for _ in range(n_steps):
        f1 = f + dt * L(f)
        f = 0.5 * f + 0.5 * (f1 + dt * L(f1)) if rk2 else f1
    return f


def _muscl_mesh(nr=32, nz=128):
    return Mesh(Cylinder[0:2, -4:4], None, [nr, nz], device="cpu", dtype="double")


def test_muscl_matches_central_on_smooth_data():
    mesh = _muscl_mesh()
    R, Z = mesh.R, mesh.Z
    f = torch.exp(-(R**2 + Z**2))
    d_c = _np(prfp.friction_apply(-0.3 * R, -0.5 * Z, f, mesh))
    d_m = _np(prfp.friction_apply_muscl(-0.3 * R, -0.5 * Z, f, mesh))
    assert np.abs(d_c - d_m)[2:-2, 2:-2].max() / np.abs(d_c).max() < 0.02


def test_muscl_positivity_central_oscillates():
    mesh = _muscl_mesh()
    f0 = torch.where((mesh.Z > -0.5) & (mesh.Z < 0.5), 1.0, 0.0).to(torch.float64)
    dz = float(mesh.dx_np[1])
    dt = 0.4 * dz
    n = int(1.5 / dt)
    f_c = _np(_advect(mesh, f0, 1.0, dt, n, "central"))
    f_m = _np(_advect(mesh, f0, 1.0, dt, n, "mc"))
    assert f_c.min() < -0.05
    assert f_m.min() > -1e-12 and f_m.max() < 1.0 + 1e-12
    tv = lambda f: np.abs(np.diff(f, axis=1)).sum()  # noqa: E731
    assert tv(f_m) <= tv(_np(f0)) + 1e-10


def test_muscl_mass_conservation():
    mesh = _muscl_mesh()
    R, Z = mesh.R, mesh.Z
    f0 = torch.exp(-4.0 * (R**2 + (Z + 1.0) ** 2))
    dt = 0.4 * float(mesh.dx_np[1])
    f1 = _advect(mesh, f0, 1.0, dt, int(1.0 / dt), "mc")
    m0, m1 = float(torch.sum(f0 * R)), float(torch.sum(f1 * R))
    assert abs(m1 - m0) / m0 < 1e-6


def test_muscl_second_order_convergence():
    errs = []
    for nz in (96, 192):
        mesh = Mesh(Cylinder[0:2, -4:4], None, [16, nz], device="cpu", dtype="double")
        Z = mesh.Z
        f0 = torch.exp(-4.0 * (Z - 1.0) ** 2)
        dt = 0.2 * float(mesh.dx_np[1])
        n = int(round(1.0 / dt))
        f1 = _np(_advect(mesh, f0, 1.0, dt, n, "mc", rk2=True))
        exact = _np(torch.exp(-4.0 * (Z + n * dt - 1.0) ** 2))
        errs.append(np.abs(f1 - exact)[:, 4:-4].mean())
    assert errs[0] / errs[1] > 3.0, errs


def test_rfp_evolution_muscl_scheme():
    mesh = _muscl_mesh(32, 48)
    f0, H, G = _smooth_state(mesh)
    out = {}
    for scheme in ("central", "muscl"):
        model = pmodels.RFPEvolution(mesh, H, G, scheme=scheme)
        out[scheme] = _np(model.run(_pfield(mesh, f0), dt=2e-4, n_steps=20)())
    assert np.all(np.isfinite(out["muscl"])) and out["muscl"].min() > -1e-12
    assert np.abs(out["muscl"] - out["central"]).max() < 5e-3 * np.abs(out["central"]).max()


def test_rfp_implicit_step():
    """``test_models.py::test_rfp_implicit_step``: the implicit steps follow
    the explicit trajectory at small dt; at 10x dt they stay finite and
    conserve density."""
    mesh = Mesh(Cylinder[0:3, -3:3], None, [32, 48], device="cpu", dtype="double")
    f0, H, G = _smooth_state(mesh)
    model = pmodels.RFPEvolution(mesh, H, G)
    fe = model.run(_pfield(mesh, f0), dt=2e-4, n_steps=10)
    fi = _pfield(mesh, f0)
    for _ in range(10):
        fi = model.step_implicit(fi, 2e-4)
    np.testing.assert_allclose(_np(fi()), _np(fe()), atol=5e-3)
    fb = _pfield(mesh, f0)
    den0 = float(fb.volume_integral()[0])
    for _ in range(5):
        fb = model.step_implicit(fb, 2e-3)
    assert np.all(np.isfinite(_np(fb())))
    assert abs(float(fb.volume_integral()[0]) - den0) / den0 < 1e-2


def test_rfp_implicit_fd_precond():
    """``test_models.py::test_rfp_implicit_fd_precond``: the hinted FD
    preconditioner gives the same solution in fewer iterations."""
    mesh = Mesh(Cylinder[0:3, -3:3], None, [32, 48], device="cpu", dtype="double")
    f0, H, G = _smooth_state(mesh)
    model = pmodels.RFPEvolution(mesh, H, G)

    def run_one(cfg):
        f, itrs = _pfield(mesh, f0), []
        for _ in range(3):
            f = model.step_implicit(f, 2e-3, config=cfg)
            itrs.append(model.report["itr"])
        return f, itrs

    f_plain, it_plain = run_one({"precond": "none", "sync": True})
    f_fd, it_fd = run_one({"sync": True})
    np.testing.assert_allclose(_np(f_fd()), _np(f_plain()), atol=1e-10)
    assert sum(it_fd) < sum(it_plain), (it_fd, it_plain)

