"""The transient Navier-Stokes slice (CPU, float64): ``LidDrivenCavity``
and ``NaturalConvection`` of the port against the JAX package, and the
JAX model tests' physical gates against the port.

(a) With ``config={"method": "bicgstab", "precond": None}`` both packages
    resolve the same solves (BiCGSTAB momentum, plain CG on the zero-mean
    pressure quotient): started from the same mid-run state
    (``utils/carry.py``), every solve takes the same iterations and the
    fields agree within 1e-8 after the steps.
(b) The default config: the port solves the separable momentum and
    pressure systems by fastdiag, the JAX package by its Krylov fallback
    (its probe rejects every domain BC), so the fields agree within the
    solves' tolerance, 2e-6 (the band of ``tests/test_fastdiag.py``).
(c) The gates of ``tests/test_models.py``'s cavity and convection tests,
    eager (the fused runner: ``tests/test_torch_fuse.py``).
(d) The ``cavity`` and ``convection`` runners with ``--device cpu``.
"""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyapes_tpu.models as jmodels  # noqa: E402
from pyapes_tpu import runner as jrunner  # noqa: E402
from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
import pyapes_tpu_torch.models as pmodels  # noqa: E402
from pyapes_tpu_torch import runner as prunner  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.models.navier_stokes import _ddx  # noqa: E402
from pyapes_tpu_torch.solver.linalg import build as build_mod  # noqa: E402
from pyapes_tpu_torch.utils.carry import model_state_from_numpy  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

KRYLOV = {"method": "bicgstab", "precond": None}


def _meshes(nx):
    box = tuple(slice(0, 1) for _ in nx)
    return (JMesh(JBox[box], None, list(nx), dtype="double"),
            Mesh(Box[box], None, list(nx), device="cpu", dtype="double"))


def _record_itr(model, out: list) -> None:
    """Append every solve's ``itr`` of the model to ``out``."""
    for solver in (model.mom_solver, model.p_solver):
        real = solver.solve

        def solve(real=real):
            rep = real()
            out.append(rep["itr"])
            return rep

        solver.solve = solve


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _state(model) -> list:
    return [(_np(f()), _np(f.VARo)) for f in model.state_fields()]


def _max_err(jm, pm) -> float:
    return max(np.abs(_np(a()) - _np(b())).max()
               for a, b in zip(jm.state_fields(), pm.state_fields()))


# (a): (grid, kwargs), each case 1 bootstrap step of the JAX model, carried
# over, then STEPS steps in both
STEPS = 10
CASES_A = {
    "2d_incremental_explicit": ((17, 17), {}),
    "2d_chorin_explicit": ((17, 17), {"incremental": False}),
    "2d_implicit_regularized": ((17, 17), {"implicit_advection": True,
                                           "lid_profile": "regularized"}),
    "2d_no_rhie_chow_uniform": ((17, 17), {"rhie_chow": False}),
    "3d_noslip_regularized": ((9, 9, 9), {"lid_profile": "regularized"}),
    "3d_symmetry_implicit": ((9, 9, 9), {"spanwise": "symmetry", "implicit_advection": True}),
    "3d_periodic_chorin": ((9, 9, 9), {"spanwise": "periodic", "incremental": False}),
}


@pytest.mark.parametrize("case", sorted(CASES_A))
def test_cavity_same_solves_as_jax(case):
    nx, kw = CASES_A[case]
    jmesh, pmesh = _meshes(nx)
    jm = jmodels.LidDrivenCavity(jmesh, nu=0.01, config=dict(KRYLOV), **kw)
    pm = pmodels.LidDrivenCavity(pmesh, nu=0.01, config=dict(KRYLOV), **kw)
    dt = 0.02
    jm.run(dt, 1)
    model_state_from_numpy(pm, _state(jm), t=jm.t)
    jitr, pitr = [], []
    _record_itr(jm, jitr)
    _record_itr(pm, pitr)
    jm.run(dt, STEPS)
    pm.run(dt, STEPS)
    assert pitr == jitr
    assert len(pitr) == STEPS * (len(nx) + 1)
    assert _max_err(jm, pm) <= 1e-8
    assert abs(pm.t - jm.t) < 1e-12


def test_natural_convection_same_solves_as_jax():
    """The buoyancy-coupled cavity with its temperature transport, from a
    carried mid-run state (``T`` after the cavity's fields)."""
    jmesh, pmesh = _meshes((17, 17))
    jm = jmodels.NaturalConvection(jmesh, ra=1e3, pr=0.71, config=dict(KRYLOV))
    pm = pmodels.NaturalConvection(pmesh, ra=1e3, pr=0.71, config=dict(KRYLOV))
    dt = 0.0125
    jm.run(dt, 2)
    model_state_from_numpy(pm, _state(jm), t=jm.t)
    jitr, pitr = [], []
    _record_itr(jm, jitr)
    _record_itr(pm, pitr)
    jm.run(dt, 5)
    pm.run(dt, 5)
    assert pitr == jitr and len(pitr) == 5 * 4
    assert _max_err(jm, pm) <= 1e-8 * max(np.abs(_np(f())).max() for f in jm.state_fields())
    assert abs(pm.nusselt_hot_wall() - jm.nusselt_hot_wall()) < 1e-10


def test_carry_rejects_a_mismatched_state():
    _, pmesh = _meshes((9, 9))
    pm = pmodels.LidDrivenCavity(pmesh)
    with pytest.raises(ValueError, match="states for"):
        model_state_from_numpy(pm, [np.zeros((1, 9, 9))] * 3)
    with pytest.raises(ValueError, match="shape"):
        model_state_from_numpy(pm, [np.zeros((1, 8, 9))] * 4)


def test_cavity_default_config_within_solve_tolerance():
    """33^2, 30 steps from rest: port fastdiag against the JAX package's
    Krylov fallback, both with their default configs."""
    jmesh, pmesh = _meshes((33, 33))
    jm = jmodels.LidDrivenCavity(jmesh, nu=0.01)
    pm = pmodels.LidDrivenCavity(pmesh, nu=0.01)
    assert pm.mom_solver.config["fdm"]["method"] == "fastdiag"
    assert pm.p_solver.config["fdm"]["nullspace"] == "mean"
    reports = []
    _record_itr(pm, reports)
    jm.run(0.02, 30)
    pm.run(0.02, 30)
    assert _max_err(jm, pm) <= 2e-6
    assert max(reports) <= 3  # fastdiag: direct, a pass or two of refinement


# -- (c) the JAX model tests' gates ------------------------------------------

def _cavity(nx, **kw):
    box = tuple(slice(0, 1) for _ in nx)
    return pmodels.LidDrivenCavity(Mesh(Box[box], None, list(nx), device="cpu",
                                        dtype="double"), **kw)


def test_lid_driven_cavity():
    """``tests/test_models.py::test_lid_driven_cavity``: Re = 100 at 33^2,
    150 eager steps."""
    model = _cavity((33, 33), nu=0.01, lid_velocity=1.0)
    model.run(dt=0.02, n_steps=150)
    u, v = _np(model.u()[0]), _np(model.v()[0])
    mid = u.shape[0] // 2
    np.testing.assert_allclose(u[:, -1][1:-1], 1.0, atol=1e-12)
    np.testing.assert_allclose(u[:, 0], 0.0, atol=1e-12)
    assert u[mid, :].min() < -0.05, u[mid, :].min()
    assert v[:, mid].max() > 0.02
    assert v[:, mid].min() < -0.02
    div = _np(model.divergence())[2:-2, 2:-2]
    assert np.mean(np.abs(div)) < 0.05, np.mean(np.abs(div))


def test_cavity_regularized_lid_corner_divergence():
    """``test_models.py::test_cavity_regularized_lid_corner_divergence``."""
    def run(profile):
        model = _cavity((49, 49), nu=0.02, lid_profile=profile)
        model.run(0.005, 30)
        div = np.abs(_np(model.divergence()))
        return max(div[:4, -4:].max(), div[-4:, -4:].max()), div[4:-4, 4:-4].mean()

    c_uni, _ = run("uniform")
    c_reg, b_reg = run("regularized")
    assert c_reg < c_uni / 10, (c_reg, c_uni)
    assert c_reg < 0.5, c_reg
    assert b_reg < 5e-3, b_reg


def test_cavity_adaptive_dt():
    """``test_models.py::test_cavity_adaptive_dt``: the CFL-adaptive loop
    reaches ``t_end``, shrinks dt as the flow spins up, and a change of dt
    builds no new eigen-factors (dt streams as a scalar)."""
    build_mod._FD_CACHE.clear()
    model = _cavity((17, 17), nu=0.01, lid_velocity=1.0)
    cfl, taken = 0.4, []
    orig_step = model.step

    def record_step(dt):
        taken.append(dt)
        orig_step(dt)

    model.step = record_step
    n = model.run_adaptive(cfl, t_end=0.2, dt_max=0.1)
    assert n == len(taken)
    assert abs(model.t - 0.2) < 1e-10
    dx = 1.0 / 16
    assert abs(taken[0] - 0.1) < 1e-12
    assert taken[-2] < 0.5 * taken[0]
    assert abs(taken[-2] - cfl * dx) < 0.2 * cfl * dx
    umax = float(model.max_velocity())
    assert 0.5 < umax <= 1.0 + 1e-6
    assert np.all(np.isfinite(_np(model.u()[0])))
    n_factors = len(build_mod._FD_CACHE)
    model.run_adaptive(cfl, t_end=0.25)
    assert len(build_mod._FD_CACHE) == n_factors


def test_cavity_3d_quasi2d_reduction():
    """``test_models.py::test_cavity_3d_quasi2d_reduction``, eager: the 3-D
    cavity with symmetry spanwise faces reproduces the 2-D cavity."""
    n, dt, steps, nu = 33, 0.01, 40, 0.05
    model2 = _cavity((n, n), nu=nu, rhie_chow=False, config={"tol": 1e-10})
    model2.run(dt, steps)
    u2 = _np(model2.u()[0])
    model3 = _cavity((n, 5, n), nu=nu, rhie_chow=False, spanwise="symmetry",
                     config={"tol": 1e-10})
    model3.run(dt, steps)
    u3, v3 = _np(model3.u()[0]), _np(model3.v()[0])
    assert np.max(np.abs(u3 - u3[:, :1, :])) < 1e-6
    assert np.max(np.abs(v3)) < 1e-6
    np.testing.assert_allclose(u3[:, 2, :], u2, atol=5e-6)
    assert u2[n // 2, -1] == 1.0
    assert u2[n // 2, 1:-1].min() < -0.1


def test_natural_convection_davis_ra1e3():
    """``test_models.py::test_natural_convection_davis_ra1e3``: the hot-wall
    Nusselt number within 3% of de Vahl Davis' 1.118."""
    mesh = Mesh(Box[0:1, 0:1], None, [33, 33], device="cpu", dtype="double")
    model = pmodels.NaturalConvection(mesh, ra=1e3, pr=0.71)
    model.run(dt=0.0125, n_steps=60)
    nu_wall = model.nusselt_hot_wall()
    assert abs(nu_wall - 1.118) < 0.03 * 1.118, nu_wall
    v = _np(model.v()[0])
    assert v.max() > 0.5 and v.min() < -0.5
    T = _np(model.T()[0])
    assert T.max() <= 1.0 + 1e-8 and T.min() >= -1e-8
    assert 1.0 < model.nusselt_avg() < 1.25


def test_natural_convection_3d_smoke():
    """``test_models.py::test_natural_convection_3d_smoke``."""
    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [17, 17, 17], device="cpu", dtype="double")
    model = pmodels.NaturalConvection(mesh, ra=1e3, pr=0.71)
    model.run(dt=0.02, n_steps=15)
    T, w = _np(model.T()[0]), _np(model.w()[0])
    assert np.all(np.isfinite(T)) and np.all(np.isfinite(w))
    assert T.max() <= 1.0 + 1e-8 and T.min() >= -1e-8
    assert np.abs(w).max() > 0.5
    assert 0.9 < model.nusselt_hot_wall() < 1.5


def test_time_varying_lid_is_evaluated_at_the_new_time():
    """A callable lid ``U(t)``: after each step the lid row holds ``U`` of
    the step's new time level (backward Euler), as in the JAX package."""
    model = _cavity((9, 9), nu=0.05, lid_velocity=lambda t: 1.0 + t)
    for k in range(1, 4):
        model.step(0.1)
        np.testing.assert_allclose(_np(model.u()[0])[1:-1, -1], 1.0 + 0.1 * k, atol=1e-12)


def test_ddx_matches_jax():
    from pyapes_tpu.models.navier_stokes import _ddx as jddx

    f = np.random.default_rng(2).standard_normal((9, 7, 5))
    for axis in range(3):
        for periodic in (False, True):
            np.testing.assert_allclose(
                _np(_ddx(torch.as_tensor(f), 0.125, axis, periodic)),
                np.asarray(jddx(f, 0.125, axis, periodic)), atol=1e-12)


# -- (d) the runners -----------------------------------------------------------

@pytest.mark.parametrize("case", ["cavity", "cavity_adaptive", "cavity_3d_implicit",
                                  "convection"])
def test_runner_matches_jax(case):
    argv = {
        "cavity": ["cavity", "--n", "17", "--steps", "10", "--dtype", "double"],
        "cavity_adaptive": ["cavity", "--n", "17", "--steps", "5", "--adaptive-cfl", "0.4",
                            "--dtype", "double"],
        "cavity_3d_implicit": ["cavity", "--n", "9", "--dim", "3", "--steps", "3",
                               "--implicit-advection", "--dtype", "double"],
        "convection": ["convection", "--n", "17", "--steps", "5", "--dtype", "double"],
    }[case]
    ours = prunner.run(argv + ["--device", "cpu"])
    ref = jrunner._run_cavity if argv[0] == "cavity" else jrunner._run_convection
    args = argparse.Namespace(
        n=int(argv[2]), dtype="double", re=100.0, dt=0.01, steps=int(argv[argv.index("--steps") + 1]),
        dim=int(argv[argv.index("--dim") + 1]) if "--dim" in argv else 2,
        implicit_advection="--implicit-advection" in argv,
        adaptive_cfl=0.4 if "--adaptive-cfl" in argv else None, fused=False, ra=1e3, pr=0.71,
        vtk=None, save=None, resume=None)
    theirs = ref(args)
    assert ours["steps"] == theirs["steps"] and abs(ours["t"] - theirs["t"]) < 1e-12
    key = "u_centerline_min" if argv[0] == "cavity" else "nusselt_hot_wall"
    assert abs(ours[key] - theirs[key]) < 2e-6, (ours[key], theirs[key])
    assert ours["wall_s"] > 0


@pytest.mark.parametrize("case", ["cavity", "convection"])
def test_runner_fused_raises(case):
    """``--fused`` no longer raises: the fused runner's numbers are the
    eager runner's, bit for bit on the CPU (``tests/test_torch_fuse.py``)."""
    argv = [case, "--n", "9", "--steps", "3", "--dtype", "double", "--device", "cpu"]
    fused, eager = prunner.run(argv + ["--fused"]), prunner.run(argv)
    key = "u_centerline_min" if case == "cavity" else "nusselt_hot_wall"
    assert fused[key] == eager[key] and fused["t"] == eager["t"]
