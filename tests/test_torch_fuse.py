"""The fused whole-step runner (``utils/fuse.py``) and ``sync: False``
solves of the port against the JAX package (CPU, float64).

Each case of ``tests/test_fuse.py`` has a counterpart of the same name and
size here (its eager-fallback case needs a capture, so it is a card test,
``tests/test_torch_cuda.py``). The gates:

* port fused against JAX fused at the JAX test's own tolerance (1e-9).
  The cavity, convection and periodic cases use ``config={"method":
  "bicgstab", "precond": None}``, with which both packages resolve the
  same solves (the default takes fastdiag in the port and the JAX
  package's Krylov fallback, ``tests/test_torch_navier_stokes.py``); the
  obstacle channel resolves alike by default;
* port fused against port eager with ``torch.equal``: on the CPU the fused
  runner steps the same state-swap core, with the solvers at ``sync:
  False`` through the same loop bodies;
* the same ``itr`` per solve, fused and eager.

``sync: False`` solves (fastdiag, CG + MG, BiCGSTAB + FD) return device
``itr``/``tol``/``history`` equal to the ``sync: True`` report and to the
JAX package's ``sync: False`` report.

On the CPU nothing is captured (``FusedStepRunner.captures`` stays 0);
on the card each distinct ``dt`` is one capture (``tests/test_torch_cuda.py``).
"""
import warnings
from math import pi

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.geometry import MaskObstacle as JMaskObstacle  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
import pyapes_tpu.models as jmodels  # noqa: E402
from pyapes_tpu.models.navier_stokes import smagorinsky_viscosity as jsmag  # noqa: E402
from pyapes_tpu_torch import runner as prunner  # noqa: E402
from pyapes_tpu_torch.geometry import Box, MaskObstacle  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
import pyapes_tpu_torch.models as pmodels  # noqa: E402
from pyapes_tpu_torch.models.navier_stokes import smagorinsky_viscosity  # noqa: E402
from pyapes_tpu_torch.solver.ops import Solver, solve_log  # noqa: E402
from pyapes_tpu_torch.utils.fuse import FusedStepRunner  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

KRYLOV = {"method": "bicgstab", "precond": None}
CYL = lambda X, Y: (X - 0.7) ** 2 + (Y - 0.5) ** 2 < 0.14**2  # noqa: E731


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _cavity(lid=1.0, sync=True, config=KRYLOV, jax=False):
    """The 17^2 cavity of ``tests/test_fuse.py`` (``nu = 0.05``)."""
    cfg = {**(config or {}), "sync": sync}
    if jax:
        mesh = JMesh(JBox[0:1, 0:1], None, [17, 17], dtype="double")
        return jmodels.LidDrivenCavity(mesh, nu=0.05, lid_velocity=lid, config=cfg)
    mesh = Mesh(Box[0:1, 0:1], None, [17, 17], device="cpu", dtype="double")
    return pmodels.LidDrivenCavity(mesh, nu=0.05, lid_velocity=lid, config=cfg)


def _assert_close(jm, pm, atol=1e-9):
    """Port model ``pm`` against JAX model ``jm``: every state field."""
    for a, b in zip(jm.state_fields(), pm.state_fields()):
        np.testing.assert_allclose(np.asarray(a()), _np(b()), atol=atol, err_msg=b.name)


def _assert_equal(m1, m2):
    """Two port models hold the same bits: values and history levels."""
    for a, b in zip(m1.state_fields(), m2.state_fields()):
        assert torch.equal(a(), b()), a.name
        assert torch.equal(a.VARo, b.VARo), a.name
        assert torch.equal(a.VARoo, b.VARoo), a.name
        assert a.n_hist == b.n_hist and a._dt == b._dt and a._t == b._t, a.name


def _step_itrs(model, dt, n, fused):
    """``n`` steps; the ``itr`` of every solve, step by step (fused: the
    steady runner's reports)."""
    out = []
    for _ in range(n):
        if fused:
            model.fused_runner().step(dt)
            out.append([int(r["itr"]) for r in model._fused.reports])
        else:
            with solve_log() as log:
                model.step(dt)
            out.append([int(r["itr"]) for r in log])
    return out


def test_fused_matches_eager_cavity():
    dt = 0.01
    jm = _cavity(jax=True)
    jm.run(dt, 8, fused=True)
    jm.run(dt, 1)
    for config in (KRYLOV, None):  # the JAX parity config, then the port's default
        m1, m2 = _cavity(config=config), _cavity(config=config)
        m1.run(dt, 2)
        m2.run(dt, 2, fused=True)
        assert _step_itrs(m1, dt, 6, False) == _step_itrs(m2, dt, 6, True)
        _assert_equal(m1, m2)
        # a further eager step after fused stepping stays in lockstep
        m1.run(dt, 1)
        m2.run(dt, 1)
        _assert_equal(m1, m2)
        if config is KRYLOV:
            _assert_close(jm, m2)


def test_fused_streamed_lid_callable():
    """A time-varying lid ``U(t)`` written with torch operations sees the
    streamed ``t`` tensor inside the fused step and rides it."""
    dt = 0.01

    def lid(t):
        return 1.0 + 0.5 * torch.sin(torch.as_tensor(3.0 * t, dtype=torch.float64))

    def jlid(t):
        return 1.0 + 0.5 * jnp.sin(3.0 * t)

    m1, m2, jm = _cavity(lid=lid), _cavity(lid=lid), _cavity(lid=jlid, jax=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any eager fallback fails the test
        m2.run(dt, 8, fused=True)
        jm.run(dt, 8, fused=True)
    m1.run(dt, 8)
    _assert_equal(m1, m2)
    _assert_close(jm, m2)
    assert m2._fused is not None and m2._fused._compiled is not None


def test_fused_restores_sync_flags():
    """The solvers' ``sync`` flags are off only for the duration of a fused
    step, as in the JAX package."""
    m, jm = _cavity(sync=True), _cavity(sync=True, jax=True)
    solvers = [v for v in vars(m).values() if isinstance(v, Solver)]
    assert solvers
    before = [s.config["fdm"].get("sync", None) for s in solvers]
    m.run(0.01, 5, fused=True)
    jm.run(0.01, 5, fused=True)
    after = [s.config["fdm"].get("sync", None) for s in solvers]
    assert before == after == [s.config["fdm"].get("sync", None)
                               for s in (jm.mom_solver, jm.p_solver)]


def test_fused_clock_metadata_parity():
    """Fused and eager runs leave the same field metadata (t, dt, n_hist),
    in the port and against the JAX package's fused run."""
    dt = 0.01
    m1, m2, jm = _cavity(), _cavity(), _cavity(jax=True)
    m1.run(dt, 6)
    m2.run(dt, 6, fused=True)
    jm.run(dt, 6, fused=True)
    for f1, f2, fj in zip(m1.state_fields(), m2.state_fields(), jm.state_fields()):
        assert f1.n_hist == f2.n_hist == fj.n_hist, f1.name
        assert f1._dt == f2._dt == fj._dt, f1.name
        assert abs(float(f1._t) - float(f2._t)) < 1e-12
        assert abs(float(fj._t) - float(f2._t)) < 1e-12
    assert abs(m1.t - m2.t) < 1e-12 and abs(jm.t - m2.t) < 1e-12


def test_fused_streams_dt_without_recompile():
    """A changing ``dt`` matches the eager sequence. On the CPU nothing is
    captured; on the card the port captures one graph per distinct ``dt``
    (three here), where the JAX program streams ``dt`` and compiles once:
    the one difference from the JAX runner (``test_torch_cuda.py``)."""
    m1, m2, jm = _cavity(), _cavity(), _cavity(jax=True)
    seq = [0.01, 0.01, 0.02, 0.005, 0.01, 0.02]
    for dt in seq:
        m1.step(dt)
    for m in (m2, jm):
        m.step(seq[0])
        m.step(seq[1])
    runner, jrunner = m2.fused_runner(), jm.fused_runner()
    for dt in seq[2:]:
        runner.step(dt)
        jrunner.step(dt)
    compiled = runner._compiled
    runner.step(0.01)
    jrunner.step(0.01)
    m1.step(0.01)
    assert runner._compiled is compiled
    assert runner.captures == 0
    assert list(compiled) == [(0.02, None), (0.005, None), (0.01, None)]
    _assert_equal(m1, m2)
    _assert_close(jm, m2)


def _convection(jax=False):
    cfg = dict(KRYLOV)
    if jax:
        return jmodels.NaturalConvection(JMesh(JBox[0:1, 0:1], None, [17, 17], dtype="double"),
                                         ra=1e3, pr=0.71, config=cfg)
    return pmodels.NaturalConvection(Mesh(Box[0:1, 0:1], None, [17, 17], device="cpu",
                                          dtype="double"), ra=1e3, pr=0.71, config=cfg)


def test_fused_natural_convection():
    """The buoyancy-coupled model (the T transport solve, T in the state):
    fused equals eager, T included, and the JAX fused run."""
    dt = 0.0125
    m1, m2, jm = _convection(), _convection(), _convection(jax=True)
    m1.run(dt, 8)
    m2.run(dt, 8, fused=True)
    jm.run(dt, 8, fused=True)
    _assert_equal(m1, m2)
    _assert_close(jm, m2)
    m1.run(dt, 1)
    m2.run(dt, 1)
    jm.run(dt, 1)
    _assert_equal(m1, m2)
    np.testing.assert_allclose(np.asarray(jm.T()), _np(m2.T()), atol=1e-9)


def test_fused_donated_state_matches_eager():
    """``fused_runner(donate=True)``: in lockstep with eager through many
    steps, and the model usable for a further eager step."""
    dt = 0.01
    m1, m2, jm = _cavity(), _cavity(), _cavity(jax=True)
    m1.run(dt, 8)
    jm.run(dt, 8, fused=True)
    while min(v.n_hist for v in m2.vel) < 2:
        m2.step(dt)
    r = m2.fused_runner(donate=True)
    assert r._donate is True
    r.run(dt, 8 - 2)
    _assert_equal(m1, m2)
    _assert_close(jm, m2)
    m1.run(dt, 1)
    m2.run(dt, 1)
    _assert_equal(m1, m2)
    # donation made every state slot own its tensor
    ptrs = [t.data_ptr() for f in m2.state_fields() for t in (f._VAR, f._VARo)]
    assert len(ptrs) == len(set(ptrs))


def _tgv(jax=False, n=16):
    L = 2 * pi
    if jax:
        mesh = JMesh(JBox[0:L, 0:L, 0:L], None, [n, n, n], dtype="double")
        m = jmodels.PeriodicFlow(mesh, nu=1 / 1600, config=dict(KRYLOV),
                                 mu_strain_fn=jsmag(1 / 1600, mesh, cs=0.17))
        X, Y, Z = mesh.X, mesh.Y, mesh.Z
        m.set_velocity(jnp.sin(X) * jnp.cos(Y) * jnp.cos(Z),
                       -jnp.cos(X) * jnp.sin(Y) * jnp.cos(Z), jnp.zeros_like(X))
        return m
    mesh = Mesh(Box[0:L, 0:L, 0:L], None, [n, n, n], device="cpu", dtype="double")
    m = pmodels.PeriodicFlow(mesh, nu=1 / 1600, config=dict(KRYLOV),
                             mu_strain_fn=smagorinsky_viscosity(1 / 1600, mesh, cs=0.17))
    X, Y, Z = mesh.grid
    m.set_velocity(torch.sin(X) * torch.cos(Y) * torch.cos(Z),
                   -torch.cos(X) * torch.sin(Y) * torch.cos(Z), torch.zeros_like(X))
    return m


def test_fused_periodic_flow_les():
    """``PeriodicFlow`` with Smagorinsky LES (the per-point ν momentum
    solves, the torus pressure) under the fused runner: no fallback,
    lockstep with eager and the JAX fused run, a further eager step."""
    dt = 0.05
    m1, m2, jm = _tgv(), _tgv(), _tgv(jax=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m2.run(dt, 4, fused=True)
        jm.run(dt, 4, fused=True)
        assert not [x for x in w if "falling back" in str(x.message)]
    assert m2._fused is not None and m2._fused._compiled is not None
    m1.run(dt, 4)
    _assert_equal(m1, m2)
    _assert_close(jm, m2)
    torch.testing.assert_close(m1._nu_field, m2._nu_field, rtol=0, atol=0)
    m1.run(dt, 1)
    m2.run(dt, 1)
    _assert_equal(m1, m2)


def test_run_batched_matches_stepped():
    """``run_batched`` equals per-step fused stepping: the final state, the
    clocks, and the per-step device diagnostics against host reads after
    each step; and the JAX package's batched series."""
    dt = 0.01
    m1, m2, jm = _cavity(), _cavity(), _cavity(jax=True)
    m1.run(dt, 2)
    ref = []
    for _ in range(6):
        m1.run(dt, 1, fused=True)
        ref.append((float(torch.mean(m1.vel[0]())), float(m1.p()[0][8, 8])))

    def diag(model):
        return torch.mean(model.vel[0]()), model.p()[0][8, 8]

    def jdiag(model):
        return jnp.mean(model.vel[0]()), model.p()[0][8, 8]

    d = m2.run_batched(dt, 8, diag_fn=diag)
    jd = jm.run_batched(dt, 8, diag_fn=jdiag)
    _assert_equal(m1, m2)
    assert m2.t == pytest.approx(m1.t)
    um, pc = _np(d[0]), _np(d[1])
    assert um.shape == (6,) and pc.shape == (6,)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(um, ref[:, 0])
    np.testing.assert_array_equal(pc, ref[:, 1])
    np.testing.assert_allclose(um, np.asarray(jd[0]), atol=1e-9)
    np.testing.assert_allclose(pc, np.asarray(jd[1]), atol=1e-9)
    m1.run(dt, 1)
    m2.run(dt, 1)
    _assert_equal(m1, m2)


def _channel(jax=False):
    if jax:
        mesh = JMesh(JBox[0:2, 0:1], [JMaskObstacle(CYL)], [49, 25], dtype="double")
        return jmodels.ChannelFlow(mesh, nu=0.05, u_in=1.0)
    mesh = Mesh(Box[0:2, 0:1], [MaskObstacle(CYL)], [49, 25], device="cpu", dtype="double")
    return pmodels.ChannelFlow(mesh, nu=0.05, u_in=1.0)


def test_run_batched_obstacle_force_series():
    """The batched run's per-step body forces (staircase and control
    volume, kept on the device): the last entry equals the host force on
    the final state, and the series the JAX package's."""
    model, jm = _channel(), _channel(jax=True)
    dt = 0.005

    def diag(m):
        return m.body_force_device(), m.body_force_cv_device(margin=3)

    d = model.run_batched(dt, 10, diag_fn=diag)
    jd = jm.run_batched(dt, 10, diag_fn=diag)
    F_st, F_cv = _np(d[0]), _np(d[1])
    assert F_st.shape == (8, 2) and F_cv.shape == (8, 2)
    np.testing.assert_allclose(F_st[-1], model.body_force(), atol=1e-9)
    np.testing.assert_allclose(F_cv[-1], model.body_force_cv(margin=3), atol=1e-9)
    np.testing.assert_allclose(F_st, np.asarray(jd[0]), atol=1e-9)
    np.testing.assert_allclose(F_cv, np.asarray(jd[1]), atol=1e-9)


# -- sync: False solves ------------------------------------------------------


def _poisson_solve(method, sync, jax=False):
    """A 17^3 f64 Poisson solve (Dirichlet faces, random RHS from a seed)
    by fastdiag, CG + MG or BiCGSTAB + FD, with the history."""
    cfg = {"method": method, "tol": 1e-10, "max_it": 200, "criterion": "residual",
           "sync": sync, "history": True}
    cfg.update({"cg": {"precond": "mg"}, "bicgstab": {"precond": "fd"}}.get(method, {}))
    rhs = np.random.default_rng(3).standard_normal((1, 17, 17, 17))
    faces = [{"bc_face": f, "bc_type": "dirichlet", "bc_val": 0.0, "bc_val_opt": None}
             for f in ("xl", "xu", "yl", "yu", "zl", "zu")]
    if jax:
        from pyapes_tpu.solver.fdm import FDM as JFDM
        from pyapes_tpu.solver.ops import Solver as JSolver
        from pyapes_tpu.variables import Field as JField

        mesh = JMesh(JBox[0:1, 0:1, 0:1], None, [17, 17, 17], dtype="double")
        var = JField("p", 1, mesh, {"domain": faces, "obstacle": None})
        s = JSolver({"fdm": cfg})
        s.set_eq(JFDM().laplacian(1.0, var) == jnp.asarray(rhs))
        return s.solve(), var
    from pyapes_tpu_torch.solver.fdm import FDM
    from pyapes_tpu_torch.variables import Field

    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [17, 17, 17], device="cpu", dtype="double")
    var = Field("p", 1, mesh, {"domain": faces, "obstacle": None})
    s = Solver({"fdm": cfg})
    s.set_eq(FDM().laplacian(1.0, var) == torch.as_tensor(rhs))
    return s.solve(), var


@pytest.mark.parametrize("method", ["fastdiag", "cg", "bicgstab"])
def test_sync_false_solve_matches_sync_true(method):
    rep, var = _poisson_solve(method, True)
    rep_a, var_a = _poisson_solve(method, False)
    jrep, jvar = _poisson_solve(method, False, jax=True)
    assert isinstance(rep_a["itr"], torch.Tensor) and rep_a["itr"].ndim == 0
    assert rep_a["converge"] is True
    assert int(rep_a["itr"]) == rep["itr"] == int(jrep["itr"])
    assert float(rep_a["tol"]) == rep["tol"]
    # the relative residuals of two implementations: equal down to roundoff
    assert float(rep_a["tol"]) == pytest.approx(float(jrep["tol"]), rel=1e-6, abs=1e-12)
    hist = _np(rep_a["history"])
    assert hist.shape == (200,) and hist.dtype == np.float32
    np.testing.assert_array_equal(hist[:rep["itr"]], rep["history"])
    assert np.isnan(hist[rep["itr"]:]).all()
    np.testing.assert_allclose(hist, np.asarray(jrep["history"]), rtol=1e-5, atol=1e-12)
    assert torch.equal(var(), var_a())
    np.testing.assert_allclose(_np(var_a()), np.asarray(jvar()), atol=1e-9)


# -- the reference's faults, not copied ----------------------------------------


def test_run_batched_fallback_returns_eager_diagnostics(monkeypatch):
    """Where the capture fails, ``run_batched`` steps eagerly and still
    returns the stacked diagnostics (the JAX package returns None)."""
    m1, m2 = _cavity(), _cavity()
    monkeypatch.setattr(type(m2), "_bootstrap_steps", lambda self, dt, n, fused: (n, False))

    def diag(model):
        return torch.mean(model.vel[0]())

    with pytest.warns(UserWarning, match="stepping eagerly"):
        d = m2.run_batched(0.01, 4, diag_fn=diag)
    ref = []
    for _ in range(4):
        m1.step(0.01)
        ref.append(diag(m1))
    assert torch.equal(d, torch.stack(ref))
    _assert_equal(m1, m2)


def test_failed_step_capture_restores_state_whole(monkeypatch):
    """A fused core that raises mid-step (as a failed capture does) leaves
    the model as it was: no stray ``_VARoo`` on a first step (the JAX core
    keeps the one the traced ``save_old`` made), the clocks and the
    attributes restored."""
    m = _cavity()
    real = type(m).step

    def step_then_fail(self, dt):
        real(self, dt)
        raise RuntimeError("operation not permitted when stream is capturing")

    before = [(f().clone(), f.n_hist, f._t, f._dt) for f in m.state_fields()]
    monkeypatch.setattr(type(m), "step", step_then_fail)
    with pytest.raises(RuntimeError):
        FusedStepRunner(m).step(0.01)
    for f, (v, nh, t, dt) in zip(m.state_fields(), before):
        assert "_VARoo" not in vars(f) and "_n_hist" not in vars(f)
        assert torch.equal(f(), v) and f.n_hist == nh and f._t == t and f._dt == dt
    assert m.t == 0.0


def test_bootstrap_steps_annotation():
    """``_bootstrap_steps`` returns ``(steps_remaining, capturable)``; its
    annotation says so (the JAX package's says ``int``)."""
    assert pmodels.LidDrivenCavity._bootstrap_steps.__annotations__["return"] == \
        "tuple[int, bool]"


# -- the features that were unported, each against the JAX package -------------


@pytest.mark.parametrize(
    "case",
    ["periodic_fused", "cg", "periodic_batched", "sync", "ns_fused", "periodic_fused_runner",
     "periodic_sync", "runner_cavity_fused", "channel_fused", "runner_convection_fused"],
)
def test_formerly_unported_feature_runs(case):
    """The features ``test_torch_guards.py`` pinned as raising until the
    fused runner was ported, each run and held against the JAX package."""
    if case in ("periodic_fused", "periodic_batched", "periodic_fused_runner", "periodic_sync"):
        L = 1.0
        mesh = Mesh(Box[0:L, 0:L], None, [9, 9], device="cpu", dtype="double")
        jmesh = JMesh(JBox[0:L, 0:L], None, [9, 9], dtype="double")
        cfg = dict(KRYLOV, sync=case != "periodic_sync")
        pm = pmodels.PeriodicFlow(mesh, nu=0.01, config=dict(cfg))
        jm = jmodels.PeriodicFlow(jmesh, nu=0.01, config=dict(cfg))
        X, Y = mesh.grid
        pm.set_velocity(-torch.cos(2 * pi * X) * torch.sin(2 * pi * Y),
                        torch.sin(2 * pi * X) * torch.cos(2 * pi * Y))
        jm.set_velocity(-jnp.cos(2 * pi * jmesh.X) * jnp.sin(2 * pi * jmesh.Y),
                        jnp.sin(2 * pi * jmesh.X) * jnp.cos(2 * pi * jmesh.Y))
        if case == "periodic_fused":
            pm.run(0.01, 3, fused=True)
            jm.run(0.01, 3, fused=True)
        elif case == "periodic_batched":
            d = pm.run_batched(0.01, 3, diag_fn=lambda m: m.kinetic_energy())
            jd = jm.run_batched(0.01, 3, diag_fn=lambda m: m.kinetic_energy())
            np.testing.assert_allclose(_np(d), np.asarray(jd), atol=1e-9)
        elif case == "periodic_fused_runner":
            pm.run(0.01, 2)
            jm.run(0.01, 2)
            pm.fused_runner().run(0.01, 2)
            jm.fused_runner().run(0.01, 2)
        else:  # every solve at sync: False, eager steps
            pm.run(0.01, 3)
            jm.run(0.01, 3)
            assert isinstance(pm.p_solver.report["itr"], torch.Tensor)
        _assert_close(jm, pm)
    elif case in ("cg", "sync"):
        rep, var = _poisson_solve("cg" if case == "cg" else "fastdiag", False)
        jrep, jvar = _poisson_solve("cg" if case == "cg" else "fastdiag", False, jax=True)
        assert int(rep["itr"]) == int(jrep["itr"])
        np.testing.assert_allclose(_np(var()), np.asarray(jvar()), atol=1e-9)
    elif case == "ns_fused":
        pm, jm = _cavity(), _cavity(jax=True)
        pm.run(0.01, 3, fused=True)
        jm.run(0.01, 3, fused=True)
        _assert_close(jm, pm)
    elif case == "channel_fused":
        pm, jm = _channel(), _channel(jax=True)
        pm.run(0.005, 3, fused=True)
        jm.run(0.005, 3, fused=True)
        _assert_close(jm, pm)
    else:
        import argparse

        from pyapes_tpu import runner as jrunner

        which = "cavity" if case == "runner_cavity_fused" else "convection"
        out = prunner.run([which, "--n", "9", "--steps", "3", "--dtype", "double", "--fused",
                           "--device", "cpu"])
        ref = (jrunner._run_cavity if which == "cavity" else jrunner._run_convection)(
            argparse.Namespace(n=9, dtype="double", re=100.0, dt=0.01, steps=3, dim=2,
                               implicit_advection=False, adaptive_cfl=None, fused=True,
                               ra=1e3, pr=0.71, vtk=None, save=None, resume=None))
        key = "u_centerline_min" if which == "cavity" else "nusselt_hot_wall"
        assert out["steps"] == ref["steps"] and abs(out["t"] - ref["t"]) < 1e-12
        # the default configs: fastdiag in the port, the Krylov fallback
        # in the JAX package (test_torch_navier_stokes.py's band)
        assert abs(out[key] - ref[key]) < 2e-6, (out[key], ref[key])
