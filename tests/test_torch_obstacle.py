"""Immersed obstacles of the port against the JAX package (CPU, float64):
the twenty cases of ``tests/test_obstacle.py``, each run through both
packages on the same numpy inputs.

* Masks, shells and body masks bit-equal (Box and ``MaskObstacle``).
* Obstacle solves (Dirichlet; Neumann, zero and nonzero flux; CG,
  BiCGSTAB, MG-PCG; a periodic axis; a dynamic body) with the same
  ``itr`` and within 1e-10, and the JAX tests' dense oracles on the
  port's own operator.
* The construction guards raise ``ValueError`` as in the JAX package.
* Host and device forces (staircase and control volume) equal the JAX
  package's within 1e-10 on the same fields.
* The flow cases (the cavity around a body, the cylinder channel) keep
  the JAX tests' gates; where a JAX test steps ``fused=True`` the port
  steps eagerly (the fused runner's parity is ``tests/test_torch_fuse.py``'s). Their step-by-step
  parity is ``tests/test_torch_channel.py``'s and
  ``test_cavity_flow_around_immersed_body``'s first steps here.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.geometry import MaskObstacle as JMaskObstacle  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.models import navier_stokes as jns  # noqa: E402
from pyapes_tpu.solver import FDM as JFDM  # noqa: E402
from pyapes_tpu.solver import Solver as JSolver  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu.variables.bcs import ObstacleDirichlet as JObstacleDirichlet  # noqa: E402
from pyapes_tpu.variables.bcs import ObstacleNeumann as JObstacleNeumann  # noqa: E402
from pyapes_tpu.variables.bcs import homogeneous_bcs as jhomogeneous  # noqa: E402
from pyapes_tpu.variables.bcs import mixed_bcs as jmixed  # noqa: E402
from pyapes_tpu_torch.geometry import Box, MaskObstacle  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.models import navier_stokes as pns  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.solver.linalg import build as build_mod  # noqa: E402
from pyapes_tpu_torch.solver.linalg import dispatch as dispatch_mod  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import ObstacleDirichlet, ObstacleNeumann  # noqa: E402
from pyapes_tpu_torch.variables.bcs import homogeneous_bcs, mixed_bcs  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

SQUARE = (slice(0.4, 0.6), slice(0.4, 0.6))
CYL = lambda X, Y: (X - 0.7) ** 2 + (Y - 0.5) ** 2 < 0.12**2  # noqa: E731


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _meshes(box, obstacles, nx):
    """The same mesh in both packages; ``obstacles`` holds ``("box",
    slices)`` or ``("mask", fn)`` entries."""
    def obs(pkg_box, pkg_mask):
        if obstacles is None:
            return None
        return [pkg_box[o] if kind == "box" else pkg_mask(o) for kind, o in obstacles]

    return (JMesh(JBox[box], obs(JBox, JMaskObstacle), list(nx), dtype="double"),
            Mesh(Box[box], obs(Box, MaskObstacle), list(nx), device="cpu", dtype="double"))


def _solve_both(meshes, domain, obstacle, cfg, rhs):
    """One Laplace/Poisson solve through both packages: ``(jax var, jax
    report, jax solver, port var, port report, port solver)``."""
    jm, pm = meshes
    jv = JField("p", 1, jm, {"domain": domain[0], "obstacle": obstacle})
    pv = Field("p", 1, pm, {"domain": domain[1], "obstacle": obstacle})
    js, ps = JSolver({"fdm": dict(cfg)}), Solver({"fdm": dict(cfg)})
    js.set_eq(JFDM().laplacian(1.0, jv) == jnp.asarray(rhs))
    ps.set_eq(FDM().laplacian(1.0, pv) == torch.as_tensor(rhs))
    return jv, js.solve(), js, pv, ps.solve(), ps


def _assert_same_solve(jrep, jv, prep, pv, tol=1e-10):
    assert prep["itr"] == jrep["itr"]
    assert prep["converge"] and jrep["converge"]
    assert np.abs(_np(pv()) - np.asarray(jv())).max() <= tol


CG = {"method": "cg", "tol": 1e-12, "max_it": 5000, "report": False, "criterion": "residual"}


def _port_Aop(solver):
    """The port's raw operator of ``solver``'s equation, ``x -> A x``."""
    terms = [solver.eqs[k] for k in sorted(solver.eqs)]
    descs = tuple(dispatch_mod._term_descriptor(r) for r in terms)
    x0 = next(iter(solver.eqs.values()))["target"]()
    tparams = tuple(dispatch_mod._term_params(r, d, x0) for r, d in zip(terms, descs))
    Aop = build_mod._make_Aop(descs)
    return lambda e: _np(Aop(torch.as_tensor(e), tparams))


def _masks_equal(jm, pm):
    assert set(jm.o_mask) == set(pm.o_mask)
    for i in jm.o_mask:
        assert list(jm.o_mask[i]) == list(pm.o_mask[i])
        for k in jm.o_mask[i]:
            assert np.array_equal(jm.o_mask[i][k], pm.o_mask[i][k])
    for a, b in zip(jm.obstacle_body_masks, pm.obstacle_body_masks):
        assert np.array_equal(a, b)
    assert np.array_equal(jm.t_mask, pm.t_mask)


def _hot(n=33, cfg=CG):
    meshes = _meshes((slice(0, 1), slice(0, 1)), [("box", SQUARE)], [n, n])
    dom = (jhomogeneous(2, 0.0, "dirichlet"), homogeneous_bcs(2, 0.0, "dirichlet"))
    return meshes, _solve_both(meshes, dom, [{"bc_type": "dirichlet", "bc_val": 1.0}], cfg,
                               np.zeros((1, n, n)))


def test_hot_obstacle_laplace_vs_dense_oracle():
    n = 33
    (jm, pm), (jv, jrep, _, pv, prep, ps) = _hot(n)
    _masks_equal(jm, pm)
    _assert_same_solve(jrep, jv, prep, pv)
    v = _np(pv()[0])
    shell = np.zeros((n, n), dtype=bool)
    for m in pm.o_mask[0].values():
        shell |= m
    assert_allclose(v[shell], 1.0, atol=1e-12)
    assert v.max() <= 1.0 + 1e-9 and v.min() >= -1e-9
    # dense oracle on the port's operator
    Aop = _port_Aop(ps)
    N = n * n
    A = np.zeros((N, N))
    for k in range(N):
        e = np.zeros((1, n, n))
        e.flat[k] = 1.0
        A[:, k] = Aop(e).ravel()
    Mm = np.zeros((n, n))
    Mm[1:-1, 1:-1] = 1
    Mm[shell] = 0
    active = Mm.ravel().astype(bool)
    xfix = np.zeros((n, n))
    xfix[shell] = 1.0
    b = -(A @ xfix.ravel())
    xfull = xfix.ravel().copy()
    xfull[active] = np.linalg.solve(A[np.ix_(active, active)], b[active])
    assert_allclose(v.ravel(), xfull, atol=1e-10)


def _insulated(n=33, method="cg", flux=0.0, source=True):
    meshes = _meshes((slice(0, 1), slice(0, 1)), [("box", SQUARE)], [n, n])
    dom = (jhomogeneous(2, 0.0, "dirichlet"), homogeneous_bcs(2, 0.0, "dirichlet"))
    rhs = np.zeros((1, n, n))
    if source:
        rhs[0, n // 4, n // 2] = -1.0
    out = _solve_both(meshes, dom, [{"bc_type": "neumann", "bc_val": flux}],
                      {**CG, "method": method}, rhs)
    return meshes, out, rhs


def _neumann_dense_oracle(pm, pv, ps, rhs, n, fold_affine):
    """The JAX tests' dense solve of the reduced system on the port's
    operator (shell cells folded onto their fluid neighbours)."""
    obn = [b for b in pv.bcs if b.bc_type == "obstacle_neumann"][0]
    raw = _port_Aop(ps)
    body = pm.obstacle_body_masks[0]
    interior = np.zeros((n, n), dtype=bool)
    interior[1:-1, 1:-1] = True
    active = (interior & ~body).ravel()
    A = np.zeros((n * n, n * n))
    for k in np.nonzero(active)[0]:
        e = np.zeros((1, n, n))
        e.flat[k] = 1.0
        A[:, k] = raw(obn.apply_linear(torch.as_tensor(e))).ravel()
    b = rhs.ravel().copy()
    if fold_affine:
        b -= raw(obn.affine_field((1, n, n), torch.float64, "cpu")).ravel()
    xfull = np.zeros(n * n)
    xfull[active] = np.linalg.solve(A[np.ix_(active, active)], b[active])
    xfull = _np(obn.apply(torch.as_tensor(xfull.reshape(1, n, n)), None)).ravel()
    check = active.copy()
    for mask, _, _, _ in obn.faces:
        check |= mask.ravel()
    return obn, xfull, check


def _shell_rule(v, obn, flux):
    for mask, axis, shift, fdx in obn.faces:
        v1 = np.roll(v, shift, axis=axis)
        v2 = np.roll(v, 2 * shift, axis=axis)
        only = mask.copy()
        for m2, _, _, _ in obn.faces:
            if m2 is not mask:
                only &= ~m2
        assert_allclose(v[only], ((4 * v1 - v2) / 3)[only] + (2.0 / 3.0) * flux * fdx,
                        atol=1e-9)


def test_insulated_obstacle_laplace_vs_dense_oracle():
    n = 33
    (jm, pm), (jv, jrep, _, pv, prep, ps), rhs = _insulated(n)
    _masks_equal(jm, pm)
    _assert_same_solve(jrep, jv, prep, pv)
    v = _np(pv()[0])
    obn, xfull, check = _neumann_dense_oracle(pm, pv, ps, rhs, n, fold_affine=False)
    _shell_rule(v, obn, 0.0)
    assert_allclose(v.ravel()[check], xfull[check], atol=1e-9)
    assert np.all(np.isfinite(v))


def test_insulated_obstacle_bicgstab_matches_cg():
    _, (jv_cg, jrep_cg, _, pv_cg, prep_cg, _), _ = _insulated()
    _, (jv_bi, jrep_bi, _, pv_bi, prep_bi, _), _ = _insulated(method="bicgstab")
    _assert_same_solve(jrep_cg, jv_cg, prep_cg, pv_cg)
    _assert_same_solve(jrep_bi, jv_bi, prep_bi, pv_bi)
    assert_allclose(_np(pv_bi()), _np(pv_cg()), atol=1e-8)


def _record_itr(model, out: list) -> None:
    for solver in (model.mom_solver, model.p_solver):
        real = solver.solve

        def solve(real=real):
            rep = real()
            out.append(rep["itr"])
            return rep

        solver.solve = solve


def test_cavity_flow_around_immersed_body():
    """The cavity with a square no-slip body: the solver choice of both
    packages (plain BiCGSTAB momentum, plain CG on the singular pressure),
    the same ``itr`` on every solve of the first 20 steps with the fields
    within 1e-8, then the JAX test's gates after 120 steps (eager)."""
    from pyapes_tpu.models import LidDrivenCavity as JCavity
    from pyapes_tpu_torch.models import LidDrivenCavity

    jm, pm = _meshes((slice(0, 1), slice(0, 1)), [("box", (slice(0.4, 0.6), slice(0.55, 0.75)))],
                     [49, 49])
    jmod = JCavity(jm, nu=0.01, lid_velocity=1.0)
    model = LidDrivenCavity(pm, nu=0.01, lid_velocity=1.0)
    assert model.mom_solver.config == jmod.mom_solver.config
    assert model.p_solver.config == jmod.p_solver.config
    ji, pi = [], []
    _record_itr(jmod, ji)
    _record_itr(model, pi)
    jmod.run(dt=0.01, n_steps=20)
    model.run(dt=0.01, n_steps=20)
    assert pi == ji
    for a, b in zip(jmod.vel + [jmod.p], model.vel + [model.p]):
        assert np.abs(np.asarray(a()) - _np(b())).max() < 1e-8
    model.run(dt=0.01, n_steps=100)

    u, v = _np(model.u()[0]), _np(model.v()[0])
    assert np.all(np.isfinite(u)) and np.all(np.isfinite(v))
    body = pm.obstacle_body_masks[0]
    assert_allclose(u[body], 0.0, atol=1e-12)
    assert_allclose(v[body], 0.0, atol=1e-12)
    speed = np.sqrt(u**2 + v**2)
    assert speed[~body].max() > 0.3
    assert np.abs(u[24, 20]) < np.abs(u[8, 32]) + 0.5
    div = _np(model.divergence())
    ok = np.ones_like(div, dtype=bool)
    ok[:2, :] = ok[-2:, :] = ok[:, :2] = ok[:, -2:] = False
    grow = body.copy()
    for _ in range(2):
        grow = (grow | np.roll(grow, 1, 0) | np.roll(grow, -1, 0)
                | np.roll(grow, 1, 1) | np.roll(grow, -1, 1))
    ok &= ~grow
    assert np.mean(np.abs(div[ok])) < 0.05, np.mean(np.abs(div[ok]))


def test_obstacle_with_mg_preconditioner():
    """MG-PCG with the plain-domain V-cycle on an obstacle system: the
    same ``itr`` as the JAX package and the plain CG solution."""
    n = 33
    _, (jv_ref, _, _, pv_ref, _, _) = _hot(n)
    _, (jv, jrep, _, pv, prep, _) = _hot(n, {**CG, "precond": "mg"})
    _assert_same_solve(jrep, jv, prep, pv)
    assert_allclose(_np(pv()), _np(pv_ref()), atol=1e-9)


def test_explicit_fdc_with_obstacle_bcs():
    """Explicit FDC operators skip the obstacle BCs (they carry no face
    normal): the port's values equal the JAX package's within 1e-12."""
    from pyapes_tpu.solver.fdc import FDC as JFDC
    from pyapes_tpu_torch.solver.fdc import FDC

    jm, pm = _meshes((slice(0, 1), slice(0, 1)), [("box", SQUARE)], [17, 17])
    cfg = {"laplacian": {"edge": False}, "grad": {"edge": False},
           "div": {"limiter": "none", "edge": False}}
    for dom, ob, init in (("neumann", {"bc_type": "dirichlet", "bc_val": 1.0}, 0),
                          ("dirichlet", {"bc_type": "neumann", "bc_val": 0.0}, 1)):
        jv = JField("p", 1, jm, {"domain": jhomogeneous(2, 0.0, dom), "obstacle": [ob]})
        pv = Field("p", 1, pm, {"domain": homogeneous_bcs(2, 0.0, dom), "obstacle": [ob]})
        vals = (pm._grid_np[0] ** 2 if init == 0 else pm._grid_np[1])[None]
        jv.set_var_tensor(jnp.asarray(vals))
        pv.set_var_tensor(torch.as_tensor(vals))
        jf, pf = JFDC(cfg), FDC(cfg)
        pairs = [(jf.laplacian(jv), pf.laplacian(pv))]
        if init == 0:
            pairs += [(jf.grad(jv), pf.grad(pv)), (jf.div(1.0, jv), pf.div(1.0, pv))]
        for a, b in pairs:
            b = _np(b)
            assert np.all(np.isfinite(b))
            assert np.abs(np.asarray(a) - b).max() <= 1e-12 * max(1.0, np.abs(b).max())


def _guard(obstacles, n_obs):
    meshes = _meshes((slice(0, 1), slice(0, 1)), obstacles, [33, 33])
    cfg = [{"bc_type": "neumann", "bc_val": 0.0}] * n_obs
    errs = []
    for m, F, h in ((meshes[0], JField, jhomogeneous), (meshes[1], Field, homogeneous_bcs)):
        with pytest.raises(ValueError) as exc:
            F("p", 1, m, {"domain": h(2, 0.0, "dirichlet"), "obstacle": cfg})
        errs.append(str(exc.value))
    assert errs[0] == errs[1]
    return errs[1]


def test_obstacle_neumann_guard_wall_adjacent():
    assert "domain boundary" in _guard([("box", (slice(0.0, 0.2), slice(0.4, 0.6)))], 1)


def test_obstacle_neumann_guard_bodies_too_close():
    msg = _guard([("box", (slice(0.25, 0.375), slice(0.375, 0.625))),
                  ("box", (slice(0.4375, 0.5625), slice(0.375, 0.625)))], 2)
    assert "inside a solid body" in msg


def test_heated_obstacle_nonzero_flux_vs_dense_oracle():
    n, V = 33, 5.0
    (jm, pm), (jv, jrep, _, pv, prep, ps), rhs = _insulated(n, flux=V, source=False)
    _assert_same_solve(jrep, jv, prep, pv)
    v = _np(pv()[0])
    assert np.all(np.isfinite(v)) and v.max() > 0.1
    obn, xfull, check = _neumann_dense_oracle(pm, pv, ps, rhs, n, fold_affine=True)
    jobn = [b for b in jv.bcs if b.bc_type == "obstacle_neumann"][0]
    assert_allclose(_np(obn.affine_field((1, n, n), torch.float64, "cpu")),
                    np.asarray(jobn.affine_field((1, n, n), jnp.float64)), rtol=0, atol=0)
    _shell_rule(v, obn, V)
    assert_allclose(v.ravel()[check], xfull[check], atol=1e-8)


def test_obstacle_with_periodic_axis():
    n = 33
    meshes = _meshes((slice(0, 1), slice(0, 1)), [("box", SQUARE)], [n, n])
    kinds = ["periodic", "periodic", "dirichlet", "dirichlet"]
    dom = (jmixed([None, None, 0.0, 0.0], kinds), mixed_bcs([None, None, 0.0, 0.0], kinds))
    jv, jrep, _, pv, prep, _ = _solve_both(meshes, dom, [{"bc_type": "dirichlet", "bc_val": 1.0}],
                                           {**CG, "tol": 1e-11}, np.zeros((1, n, n)))
    _assert_same_solve(jrep, jv, prep, pv)
    v = _np(pv()[0])
    assert_allclose(v[0, :], v[-1, :], atol=1e-12)
    assert v.max() <= 1.0 + 1e-9 and v.min() >= -1e-9
    shell = np.zeros((n, n), dtype=bool)
    for m in meshes[1].o_mask[0].values():
        shell |= m
    assert_allclose(v[shell], 1.0, atol=1e-12)


def test_mask_obstacle_cylinder_shells():
    """A circular ``MaskObstacle``: shells and body bit-equal to the JAX
    package's, each shell cell solid with a fluid face neighbour, every
    solid boundary cell in some shell."""
    body_fn = lambda X, Y: (X - 0.5) ** 2 + (Y - 0.5) ** 2 < 0.15**2  # noqa: E731
    jm, pm = _meshes((slice(0, 1), slice(0, 1)), [("mask", body_fn)], [65, 65])
    _masks_equal(jm, pm)
    body = pm.obstacle_body_masks[0]
    assert body.sum() > 100
    shells = pm.o_mask[0]
    assert set(shells) == {"xl", "xu", "yl", "yu"}
    for key, m in shells.items():
        axis = 0 if key[0] == "x" else 1
        shift = 1 if key[1] == "l" else -1
        assert (m & ~body).sum() == 0
        assert (np.roll(m, -shift, axis) & ~body).sum() == m.sum()
    boundary = body & ~(np.roll(body, 1, 0) & np.roll(body, -1, 0)
                        & np.roll(body, 1, 1) & np.roll(body, -1, 1))
    union = np.zeros_like(body)
    for m in shells.values():
        union |= m
    assert (boundary & ~union).sum() == 0


@pytest.fixture(scope="module")
def cylinder_runs():
    """The port's cylinder channel of the JAX tests (97 x 33, nu 0.02,
    dt 0.005), stepped eagerly: the state after 40 steps (the flow and
    force tests) and after 60 (the control-volume test)."""
    from pyapes_tpu_torch.models import ChannelFlow

    pm = Mesh(Box[0:3, 0:1], [MaskObstacle(CYL)], [97, 33], device="cpu", dtype="double")
    model = ChannelFlow(pm, nu=0.02, u_in=1.0)
    model.run(dt=0.005, n_steps=40)
    at40 = {"u": _np(model.u()[0]), "v": _np(model.v()[0]), "p": _np(model.p()[0]),
            "flux": (model.flux(0), model.flux(-1)), "F": model.body_force(),
            "F_dev": _np(model.body_force_device())}
    model.run(dt=0.005, n_steps=20)
    return pm, model, at40


def test_mask_obstacle_flow_past_cylinder(cylinder_runs):
    pm, _, s = cylinder_runs
    fin, fout = s["flux"]
    assert abs(fin - fout) / abs(fin) < 0.02, (fin, fout)
    u = s["u"]
    body = pm.obstacle_body_masks[0]
    assert np.abs(u[body]).max() < 1e-6
    iy = 16
    ix_body = int(np.nonzero(body[:, iy])[0].max())
    assert u[ix_body + 2, iy] < 0.5 * u[10, iy]


def test_body_force_quadrature_identities():
    """Zero fields give zero; a constant pressure integrates to zero; p = x
    gives about ``-V_body e_x``; each force equal to the JAX package's on
    the same fields within 1e-10."""
    from pyapes_tpu_torch.models import ChannelFlow

    body_fn = lambda X, Y: (X - 1.0) ** 2 + (Y - 0.5) ** 2 < 0.2**2  # noqa: E731
    pm = Mesh(Box[0:3, 0:1], [MaskObstacle(body_fn)], [193, 65], device="cpu", dtype="double")
    model = ChannelFlow(pm, nu=0.02, u_in=1.0)
    body = pm.obstacle_body_masks[0]
    dx = [float(d) for d in pm.dx_np]

    def both():
        p, vels = _np(model.p()[0]), [_np(v()[0]) for v in model.vel]
        F = model.body_force()
        Fj = np.asarray(jns.staircase_body_force(jnp.asarray(p), [jnp.asarray(v) for v in vels],
                                                 body, dx, 0.02))
        assert np.abs(F - Fj).max() <= 1e-10
        return F

    assert np.allclose(both(), 0.0)
    model.p.set_var_tensor(torch.full((1,) + tuple(pm.nx), 7.3, dtype=torch.float64))
    assert np.abs(both()).max() < 1e-4
    model.p.set_var_tensor(torch.as_tensor(pm._grid_np[0])[None])
    Fx = both()
    v_body = body.sum() * float(np.prod(pm.dx_np))
    assert Fx[0] < 0
    assert abs(Fx[0] + v_body) < 0.3 * v_body, (Fx[0], -v_body)
    assert abs(Fx[1]) < 0.05 * v_body


def test_body_force_cylinder_drag_lift(cylinder_runs):
    """Positive drag, small lift, and the host and device staircase forces
    equal to the JAX package's on the port's flow within 1e-10."""
    pm, _, s = cylinder_runs
    F = s["F"]
    assert np.isfinite(F).all()
    assert F[0] > 0.0, F
    assert abs(F[1]) < 0.3 * F[0], F
    dx = [float(d) for d in pm.dx_np]
    Fj = np.asarray(jns.staircase_body_force(jnp.asarray(s["p"]), [jnp.asarray(s["u"]),
                                                                   jnp.asarray(s["v"])],
                                             pm.obstacle_body_masks[0], dx, 0.02))
    assert np.abs(F - Fj).max() <= 1e-10
    assert np.abs(s["F_dev"] - Fj).max() <= 1e-10


def test_body_force_moving_body_at_rest_fluid():
    n = 65
    x = np.linspace(0, 1, n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    body = (np.abs(X - 0.5) < 0.15) & (np.abs(Y - 0.5) < 0.15)
    z = np.zeros((n, n))
    args = (body, [1 / (n - 1)] * 2)
    F = pns.staircase_body_force(torch.as_tensor(z), [torch.as_tensor(z)] * 2, *args, nu=0.1,
                                 u_body=[0.5, 0.0])
    Fj = np.asarray(jns.staircase_body_force(jnp.asarray(z), [jnp.asarray(z)] * 2, *args,
                                             nu=0.1, u_body=[0.5, 0.0]))
    assert F[0] < 0.0, F
    assert abs(F[1]) < 1e-12, F
    assert np.abs(F - Fj).max() <= 1e-10


def test_dynamic_obstacle_with_periodic_axis():
    """A dynamic (moving) body on a periodic axis: each solve reads the
    current mask, so the streamed solve equals a static one at every
    position, with the JAX package's ``itr`` and values; a body on the
    duplicate seam plane raises."""
    n = 33
    pm = Mesh(Box[0:1, 0:1], None, [n, n], device="cpu", dtype="double")
    jm = JMesh(JBox[0:1, 0:1], None, [n, n], dtype="double")
    kinds = ["periodic", "periodic", "dirichlet", "dirichlet"]
    pbc, jbc = mixed_bcs([None, None, 0.0, 0.0], kinds), jmixed([None, None, 0.0, 0.0], kinds)

    def body_at(shift):
        m = np.zeros((n, n), dtype=bool)
        for c in [(8 + shift + k) % (n - 1) for k in range(5)]:
            m[c, 14:19] = True
        return m

    def solve_static(mask):
        var = Field("p", 1, pm, {"domain": pbc})
        var.bcs.append(ObstacleDirichlet("body", 1.0, mask))
        s = Solver({"fdm": dict(CG)})
        s.set_eq(FDM().laplacian(1.0, var) == torch.zeros_like(var()))
        s.solve()
        return _np(var()[0])

    var = Field("p", 1, pm, {"domain": pbc})
    obc = ObstacleDirichlet("body", 1.0, body_at(0), dynamic=True)
    var.bcs.append(obc)
    jvar = JField("p", 1, jm, {"domain": jbc})
    jobc = JObstacleDirichlet("body", 1.0, body_at(0), dynamic=True)
    jvar.bcs.append(jobc)
    s, js = Solver({"fdm": dict(CG)}), JSolver({"fdm": dict(CG)})
    dispatch_mod.clear_cache()
    for shift in (0, 7, 15):
        obc.bc_mask = jobc.bc_mask = body_at(shift)
        s.set_eq(FDM().laplacian(1.0, var) == torch.zeros_like(var()))
        js.set_eq(JFDM().laplacian(1.0, jvar) == jnp.zeros_like(jvar()))
        rep, jrep = s.solve(), js.solve()
        _assert_same_solve(jrep, jvar, rep, var)
        v = _np(var()[0])
        assert_allclose(v[0, :], v[-1, :], atol=1e-12)
        assert_allclose(v, solve_static(body_at(shift)), atol=1e-9)
        assert_allclose(v[body_at(shift)], 1.0, atol=1e-9)
        assert v.max() <= 1.0 + 1e-9 and v.min() >= -1e-9
    # a dynamic mask is never cached on the device: each solve reads the
    # BC's current mask
    assert not obc._dev
    seam = np.zeros((n, n), dtype=bool)
    seam[-1, 14:19] = True
    obc.bc_mask = seam
    s.set_eq(FDM().laplacian(1.0, var) == torch.zeros_like(var()))
    with pytest.raises(NotImplementedError, match="seam"):
        s.solve()


def test_cv_force_quadrature_exactness():
    nx, ny = 61, 41
    x = np.linspace(0.0, 3.0, nx)
    y = np.linspace(0.0, 1.0, ny)
    X, Y = np.meshgrid(x, y, indexing="ij")
    dx = [x[1] - x[0], y[1] - y[0]]
    lo, hi = [10, 8], [40, 30]
    nu, U = 0.05, 1.0
    z = np.zeros_like(X)
    assert np.abs(pns.control_volume_force(z, [z, z], dx, lo, hi, nu)).max() == 0.0
    Fp = pns.control_volume_force(X, [z, z], dx, lo, hi, nu)
    v_cv = (x[hi[0]] - x[lo[0]]) * (y[hi[1]] - y[lo[1]])
    assert abs(Fp[0] + v_cv) < 1e-12 and abs(Fp[1]) < 1e-12
    u = 4.0 * U * Y * (1.0 - Y)
    p = 2.5 - 8.0 * nu * U * X
    Fb = pns.control_volume_force(p, [u, z], dx, lo, hi, nu)
    assert np.abs(Fb).max() < 1e-12
    for args in ((X, [z, z]), (p, [u, z])):
        Fj = jns.control_volume_force(*args, dx, lo, hi, nu)
        Fd = pns.control_volume_force_device(torch.as_tensor(args[0]),
                                             [torch.as_tensor(a) for a in args[1]],
                                             dx, lo, hi, nu)
        assert np.abs(pns.control_volume_force(*args, dx, lo, hi, nu) - Fj).max() <= 1e-12
        assert np.abs(_np(Fd) - Fj).max() <= 1e-12


def test_cv_force_cylinder_vs_staircase(cylinder_runs):
    """After 60 steps: the CV force is margin-invariant and consistent
    with the staircase drag; the host and device CV forces equal the JAX
    package's on the same fields (unsteady term included) within 1e-10."""
    pm, model, _ = cylinder_runs
    F_st = model.body_force()
    F3 = model.body_force_cv(margin=3)
    F6 = model.body_force_cv(margin=6)
    assert abs(F6[0] - F3[0]) < 0.1 * abs(F3[0]), (F3, F6)
    assert abs(F3[0] - F_st[0]) < 0.35 * abs(F_st[0]), (F3, F_st)
    assert F3[0] > 0.0
    assert abs(F3[1]) < 0.2 * abs(F3[0]), F3
    lo, hi = model._cv_box(0, 3)
    vels = [np.asarray(_np(v()[0])) for v in model.vel]
    olds = [np.asarray(_np(v.VARo[0])) for v in model.vel]
    Fj = jns.control_volume_force(_np(model.p()[0]), vels, list(pm.dx_np), lo, hi, 0.02,
                                  vels_old=olds, dt=0.005)
    assert np.abs(F3 - Fj).max() <= 1e-10
    assert np.abs(_np(model.body_force_cv_device(margin=3)) - Fj).max() <= 1e-10


def test_cv_force_device_matches_host():
    rng = np.random.default_rng(7)
    nx, ny = 41, 31
    x = np.linspace(0.0, 2.0, nx)
    y = np.linspace(0.0, 1.0, ny)
    X, Y = np.meshgrid(x, y, indexing="ij")
    dx = [x[1] - x[0], y[1] - y[0]]
    lo, hi = [6, 5], [30, 24]
    nu = 0.03
    p = np.sin(2 * X) * np.cos(3 * Y) + 0.1 * rng.standard_normal(X.shape)
    u = Y * (1 - Y) + 0.05 * rng.standard_normal(X.shape)
    v = 0.1 * np.sin(X) + 0.05 * rng.standard_normal(X.shape)
    uo = u - 0.01 * rng.standard_normal(X.shape)
    vo = v - 0.01 * rng.standard_normal(X.shape)
    T = torch.as_tensor
    F_host = pns.control_volume_force(p, [u, v], dx, lo, hi, nu, vels_old=[uo, vo], dt=0.01)
    F_dev = pns.control_volume_force_device(T(p), [T(u), T(v)], dx, lo, hi, nu,
                                            vels_old=[T(uo), T(vo)], dt=0.01)
    F_jax = jns.control_volume_force(p, [u, v], dx, lo, hi, nu, vels_old=[uo, vo], dt=0.01)
    assert_allclose(_np(F_dev), F_host, rtol=1e-12, atol=1e-13)
    assert_allclose(F_host, F_jax, rtol=1e-12, atol=1e-13)
    nu_field = 0.02 + 0.01 * np.cos(X * Y)
    F_host2 = pns.control_volume_force(p, [u, v], dx, lo, hi, nu_field)
    F_dev2 = pns.control_volume_force_device(T(p), [T(u), T(v)], dx, lo, hi, T(nu_field))
    assert_allclose(_np(F_dev2), F_host2, rtol=1e-12, atol=1e-13)
    assert_allclose(F_host2, jns.control_volume_force(p, [u, v], dx, lo, hi, nu_field),
                    rtol=1e-12, atol=1e-13)


def test_staircase_force_device_matches_host():
    rng = np.random.default_rng(3)
    n = 33
    x = np.linspace(0, 1, n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    body = (X - 0.5) ** 2 + (Y - 0.5) ** 2 < 0.15**2
    dx = [x[1] - x[0]] * 2
    p, u, v = (rng.standard_normal((n, n)) for _ in range(3))
    T = torch.as_tensor
    F_host = pns.staircase_body_force(T(p), [T(u), T(v)], body, dx, 0.04)
    F_dev = pns.staircase_body_force_device(T(p), [T(u), T(v)], body, dx, 0.04)
    F_jax = np.asarray(jns.staircase_body_force_device(jnp.asarray(p),
                                                       [jnp.asarray(u), jnp.asarray(v)],
                                                       body, dx, 0.04))
    assert_allclose(_np(F_dev), F_host, rtol=1e-12, atol=1e-13)
    assert_allclose(F_host, F_jax, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("sources_in_shells", [False, True], ids=["merged", "per_face"])
@pytest.mark.parametrize("bc_val", [0.0, 0.7])
def test_neumann_shell_update_matches_jax(sources_in_shells, bc_val):
    """The shell update's gathers and scatters against the JAX package's
    per-face rolls, bit for bit: one merged plan where no source is a shell
    cell, one plan per face in the faces' order where one is (faces that
    read each other's shells, built without the guards); ``apply``,
    ``apply_`` (in place), ``apply_linear`` and ``affine_field``."""
    rng = np.random.default_rng(11)
    shape = (13, 11)
    if sources_in_shells:
        masks = [rng.random(shape) < 0.25 for _ in range(4)]
    else:
        masks = [np.zeros(shape, dtype=bool) for _ in range(4)]
        masks[0][6, 4:7] = masks[1][8, 4:7] = True    # x faces of a 3 x 3 block
        masks[2][6:9, 4] = masks[3][6:9, 6] = True    # y faces, sharing its corners
    faces = [(masks[0], 0, 1, 0.1), (masks[1], 0, -1, 0.1),
             (masks[2], 1, 1, 0.2), (masks[3], 1, -1, 0.2)]
    body = np.zeros(shape, dtype=bool)
    bc = ObstacleNeumann("b", bc_val, faces, body)
    jbc = JObstacleNeumann("b", bc_val, faces, body)
    assert len(bc._plans) == (4 if sources_in_shells else 1)
    x = rng.standard_normal((1, *shape))
    want = np.asarray(jbc.apply(jnp.asarray(x), None))
    np.testing.assert_array_equal(_np(bc.apply(torch.as_tensor(x), None)), want)
    xt = torch.as_tensor(x.copy())
    bc.apply_(xt, None)
    np.testing.assert_array_equal(_np(xt), want)
    np.testing.assert_array_equal(_np(bc.apply_linear(torch.as_tensor(x))),
                                  np.asarray(jbc.apply_linear(jnp.asarray(x), None)))
    np.testing.assert_array_equal(
        _np(bc.affine_field((1, *shape), torch.float64, "cpu")),
        np.asarray(jbc.affine_field((1, *shape), jnp.float64)))
