"""The implicit-advection slice against the JAX package (CPU, float64):
whole transient steps of ``AdvectionDiffusion``, ``BurgersND`` and
``Burgers1D`` through ``model.step`` -> ``Solver`` -> ``linalg.solve``, the
``burgers`` runner, and the pieces they run: ``Ddt`` (backward Euler and
BDF2, the debug ``Aop``), periodic faces and the torus reduction, the FD
preconditioner's three branches and its per-call scalars.

Tolerances: in float64 both packages run the same arithmetic in another
summation order (host eigen-factors, roll vs gather), so every solve takes
the same BiCGSTAB iterations and the fields after the steps agree to
1e-10 relative.
"""
import argparse
import json
import os
import subprocess
import sys
from math import pi

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyapes_tpu.models as jmodels  # noqa: E402
from pyapes_tpu import runner as jrunner  # noqa: E402
from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.solver.fdm import FDM as JFDM  # noqa: E402
from pyapes_tpu.solver.ops import Solver as JSolver  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu.variables.bcs import homogeneous_bcs as jhomogeneous  # noqa: E402
import pyapes_tpu_torch.models as pmodels  # noqa: E402
from pyapes_tpu_torch import runner as prunner  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops import advect, axis_stencil as axis_mod  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.solver import fastdiag as fastdiag_mod  # noqa: E402
from pyapes_tpu_torch.solver import linalg  # noqa: E402
from pyapes_tpu_torch.solver.linalg import build as build_mod  # noqa: E402
from pyapes_tpu_torch.utils.carry import field_from_numpy  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import homogeneous_bcs  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = ["xl", "xu", "yl", "yu", "zl", "zu"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _bcs(kinds, vals):
    return [{"bc_face": f, "bc_type": k, "bc_val": v, "bc_val_opt": None}
            for f, k, v in zip(FACES, kinds, vals)]


def _meshes(box, nx):
    return (JMesh(JBox[box], None, list(nx), dtype="double"),
            Mesh(Box[box], None, list(nx), device="cpu", dtype="double"))


UNIT3 = (slice(0, 1), slice(0, 1), slice(0, 1))
TORUS3 = (slice(0, 2 * pi),) * 3
# Neumann faces with nonzero values (the Div's RHS correction) beside
# Dirichlet ones; every Neumann axis has >= 4 nodes
MIXED = (["neumann", "dirichlet", "dirichlet", "neumann", "dirichlet", "neumann"],
         [0.3, 0.0, 1.0, 0.0, 0.0, -0.2])


# -- whole steps of the models ----------------------------------------------

AD_CASES = {
    # (velocity: "field" or a float, limiter, form, faces)
    "field_upwind_neumann": ("field", "upwind", None, MIXED),
    "field_central_conservative": ("field", "none", "conservative", MIXED),
    "field_central_advective": ("field", "none", "advective", (["dirichlet"] * 6, [0.0] * 6)),
    "const_quick": (1.0, "quick", None, MIXED),
    "const_upwind": (-0.7, "upwind", None, MIXED),
}


@pytest.mark.parametrize("case", sorted(AD_CASES))
def test_advection_diffusion_steps_vs_jax(case):
    """``AdvectionDiffusion.step`` (BiCGSTAB + FD preconditioner with
    ``fd_fallback``, the model's config) against the JAX model."""
    velocity, limiter, form, (kinds, vals) = AD_CASES[case]
    nx = (8, 9, 7)
    rng = np.random.default_rng(3)
    phi0 = rng.standard_normal((1, *nx))
    if velocity == "field":
        velocity = 1.0 + 0.5 * rng.standard_normal((1, *nx))
    jm, pm = _meshes(UNIT3, nx)
    cfg = _bcs(kinds, vals)
    jvel = velocity if isinstance(velocity, float) else jnp.asarray(velocity)
    ja = jmodels.AdvectionDiffusion(jm, cfg, velocity=jvel, epsilon=0.05, limiter=limiter,
                                    init_val=jnp.asarray(phi0))
    pa = pmodels.AdvectionDiffusion(pm, cfg, velocity=velocity, epsilon=0.05, limiter=limiter,
                                    init_val=phi0)
    if form is not None:  # the model's discretization with the Div form set
        ja.fdm = JFDM({"div": {"limiter": limiter, "edge": False, "form": form}})
        pa.fdm = FDM({"div": {"limiter": limiter, "edge": False, "form": form}})
    for _ in range(2):
        ja.step(1e-2)
        pa.step(1e-2)
        assert pa.report["converge"] and pa.report["itr"] == ja.report["itr"]
        assert _rel(pa.var().numpy(), ja.var()) <= 1e-10


@pytest.mark.parametrize("nx", [(9, 8, 10), (12, 9)], ids=["3d", "2d"])
def test_burgers_nd_steps_vs_jax(nx):
    """``BurgersND`` on a small periodic box: one implicit ``ddt + conv -
    nu lap`` solve per component against the previous step's velocity."""
    rng = np.random.default_rng(0)
    init = [0.5 * rng.standard_normal((1, *nx)) for _ in nx]
    jm, pm = _meshes(TORUS3[: len(nx)], nx)
    jb = jmodels.BurgersND(jm, nu=0.1, init_vals=[jnp.asarray(i) for i in init])
    pb = pmodels.BurgersND(pm, nu=0.1, init_vals=init)
    calls = []
    real = linalg.solve
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("pyapes_tpu_torch.solver.ops.linalg.solve",
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        for _ in range(2):
            jb.step(0.01)
            pb.step(0.01)
            assert pb.report["itr"] == jb.report["itr"] and pb.report["converge"]
            for jv, pv in zip(jb.vel, pb.vel):
                assert _rel(pv().numpy(), jv()) <= 1e-10
    # conv(uvec, var): the advector is not the solved field, so Picard
    # takes no second sweep
    assert len(calls) == 2 * len(nx)


def test_burgers_1d_picard_steps_vs_jax():
    """``Burgers1D``: ``div(var, var)`` refreshes its frozen advection from
    the iterate, two Picard sweeps per step."""
    jm, pm = _meshes((slice(0, 2 * pi),), (33,))
    jb, pb = jmodels.Burgers1D(jm), pmodels.Burgers1D(pm)
    assert _rel(pb.var().numpy(), jb.var()) <= 1e-12  # burger_exact_nd at t = 0
    calls = []
    real = linalg.solve
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("pyapes_tpu_torch.solver.ops.linalg.solve",
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        for _ in range(3):
            jb.step(0.01)
            pb.step(0.01)
            assert pb.report["itr"] == jb.report["itr"] and pb.report["converge"]
            assert _rel(pb.var().numpy(), jb.var()) <= 1e-10
    assert len(calls) == 3 * 2
    assert pb.var.t == jb.var.t


def test_runner_burgers_vs_jax(monkeypatch):
    """``runner burgers`` (the CLI, f64): the JAX runner's JSON keys and
    time; in process, the model it stepped against the JAX model."""
    out = subprocess.run(
        [sys.executable, "-m", "pyapes_tpu_torch.runner", "burgers", "--n", "33", "--steps",
         "4", "--dtype", "double", "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    ref = jrunner._run_burgers(argparse.Namespace(n=33, dtype="double", dt=0.01, steps=4,
                                                  vtk=None, save=None, resume=None))
    assert sorted(got) == sorted(ref) and got["steps"] == 4 and got["t"] == ref["t"]

    made = []
    real = pmodels.Burgers1D
    monkeypatch.setattr(pmodels, "Burgers1D", lambda *a, **k: made.append(real(*a, **k))
                        or made[-1])
    prunner.run(["burgers", "--n", "33", "--steps", "4", "--dtype", "double", "--device", "cpu"])
    jm = JMesh(JBox[0:2 * pi], None, [33], dtype="double")
    jb = jmodels.Burgers1D(jm, nu=0.1)
    for _ in range(4):
        jb.step(0.01)
    assert made[0].report["itr"] == jb.report["itr"]
    assert _rel(made[0].var().numpy(), jb.var()) <= 1e-10


# -- Ddt, periodic faces, the FD preconditioner ------------------------------

PERIODIC_MIXED = (["periodic", "periodic", "dirichlet", "neumann", "neumann", "dirichlet"],
                  [None, None, 0.5, 0.2, 0.0, 0.0])


def _transient_pair(nx, faces, seed, scheme="euler"):
    """The same field and RHS in both packages, for ``ddt - nu lap`` (+ an
    optional constant advection) solves."""
    rng = np.random.default_rng(seed)
    phi0 = rng.standard_normal((1, *nx))
    rhs = rng.standard_normal((1, *nx))
    jm, pm = _meshes(UNIT3[: len(nx)], nx)
    cfg = _bcs(*faces)
    jv = JField("c", 1, jm, {"domain": cfg, "obstacle": None}, init_val=jnp.asarray(phi0))
    pv = Field("c", 1, pm, {"domain": cfg, "obstacle": None}, init_val=phi0)
    return jv, pv, jnp.asarray(rhs), torch.from_numpy(rhs)


def _eq(fdm, var, rhs, adv=None, scheme="euler"):
    eq = fdm.ddt(var, scheme) - fdm.laplacian(0.3, var)
    if adv is not None:
        eq = eq + fdm.div(adv, var)
    return eq == rhs


@pytest.mark.parametrize("method", ["fastdiag", "bicgstab_fd", "cg_fd"])
def test_periodic_ddt_laplacian_vs_jax(method):
    """``ddt - nu lap`` with periodic x (solved on the reduced torus, the
    seam node re-appended) and Dirichlet/Neumann y, z: the direct solve
    (the ddt shift streams into the eigen-symbol) and the Krylov solves
    preconditioned by it."""
    cfg = {"fastdiag": {"method": "fastdiag", "tol": 1e-10, "max_it": 5},
           "bicgstab_fd": {"method": "bicgstab", "precond": "fd", "tol": 1e-10, "max_it": 200},
           "cg_fd": {"method": "cg", "precond": "fd", "tol": 1e-10, "max_it": 200}}[method]
    jv, pv, jr, pr = _transient_pair((9, 8, 7), PERIODIC_MIXED, 5)
    js, ps = JSolver({"fdm": dict(cfg)}), Solver({"fdm": dict(cfg)})
    for var, s, fdm, rhs in ((jv, js, JFDM(), jr), (pv, ps, FDM(), pr)):
        var.set_time(0.05, 0.0)
        var.save_old()
        s.set_eq(_eq(fdm, var, rhs))
        s.solve()
    assert ps.report["converge"] and ps.report["itr"] == js.report["itr"]
    x = pv().numpy()
    assert _rel(x, jv()) <= 1e-10
    assert np.array_equal(x[:, -1], x[:, 0])  # the duplicate seam node


def test_new_dt_on_a_cached_solve_is_used_at_once(monkeypatch):
    """A second step at another ``dt`` streams ``c_dt = 1/dt`` into the
    FD preconditioner in that very solve, and re-factorizes nothing (the
    eigen-factors are keyed by the axis matrices, which ``dt`` leaves
    alone)."""
    cfg = {"method": "bicgstab", "precond": "fd", "tol": 1e-10, "max_it": 200}
    jv, pv, jr, pr = _transient_pair((9, 8, 7), PERIODIC_MIXED, 6)
    js, ps = JSolver({"fdm": dict(cfg)}), Solver({"fdm": dict(cfg)})
    seen, built = [], []
    real_set, real_fd = fastdiag_mod.FDPrecond.set_scalars, fastdiag_mod.FastDiag.__init__
    monkeypatch.setattr(fastdiag_mod.FDPrecond, "set_scalars",
                        lambda self, a, d: seen.append((a, d)) or real_set(self, a, d))
    monkeypatch.setattr(fastdiag_mod.FastDiag, "__init__",
                        lambda self, *a, **k: built.append(1) or real_fd(self, *a, **k))
    build_mod._FD_CACHE.clear()
    t = 0.0
    for dt in (0.1, 0.025):
        for var, s, fdm, rhs in ((jv, js, JFDM(), jr), (pv, ps, FDM(), pr)):
            var.set_time(dt, t)
            var.save_old()
            s.set_eq(_eq(fdm, var, rhs))
            s.solve()
        t += dt
        assert ps.report["itr"] == js.report["itr"]
        assert _rel(pv().numpy(), jv()) <= 1e-10
    assert seen == [(-0.3, 1 / 0.1), (-0.3, 1 / 0.025)]
    assert len(built) == 1


def test_fd_precond_branches_vs_jax(monkeypatch):
    """The FD preconditioner of ``ddt + div(const) - nu lap``: several axis
    terms sum their matrices with the weights frozen (``c_ax`` pinned to
    1, ``c_dt`` streamed); QUICK's 5-point axes raise ``ValueError``, and
    under ``fd_fallback`` the solve runs unpreconditioned — as the JAX
    package."""
    seen = []
    real_set = fastdiag_mod.FDPrecond.set_scalars
    monkeypatch.setattr(fastdiag_mod.FDPrecond, "set_scalars",
                        lambda self, a, d: seen.append((a, d)) or real_set(self, a, d))
    faces = (["dirichlet", "neumann", "dirichlet", "dirichlet", "neumann", "dirichlet"],
             [0.0, 0.3, 0.0, 0.0, 0.0, 0.0])

    def run(limiter, cfg, pkg):
        jv, pv, jr, pr = _transient_pair((9, 8, 7), faces, 8)
        var, s, fdm, rhs = ((jv, JSolver({"fdm": dict(cfg)}), JFDM({"div": {"limiter": limiter}}),
                             jr) if pkg == "jax" else
                            (pv, Solver({"fdm": dict(cfg)}), FDM({"div": {"limiter": limiter}}),
                             pr))
        var.set_time(0.02, 0.0)
        var.save_old()
        s.set_eq(_eq(fdm, var, rhs, adv=0.8))
        s.solve()
        return var, s.report

    fd = {"method": "bicgstab", "precond": "fd", "tol": 1e-10, "max_it": 400}
    jv, jrep = run("upwind", fd, "jax")
    pv, prep = run("upwind", fd, "port")
    assert prep["itr"] == jrep["itr"] and _rel(pv().numpy(), jv()) <= 1e-10
    assert seen == [(1.0, 1 / 0.02)]

    with pytest.raises(ValueError):
        run("quick", fd, "port")
    with pytest.raises(ValueError):
        run("quick", fd, "jax")
    fallback = {**fd, "fd_fallback": "bicgstab"}
    plain = {k: v for k, v in fd.items() if k != "precond"}
    jv, jrep = run("quick", fallback, "jax")
    pv, prep = run("quick", fallback, "port")
    _, prep_plain = run("quick", plain, "port")
    assert prep["itr"] == jrep["itr"] == prep_plain["itr"]
    assert _rel(pv().numpy(), jv()) <= 1e-10


@pytest.mark.parametrize("scheme", ["euler", "bdf2"])
def test_ddt_steps_and_debug_aop_vs_jax(scheme):
    """Three steps of ``ddt(var, scheme) + div(u_field, var) - nu lap``
    (BDF2 bootstraps as backward Euler on the first step) and the debug
    ``Solver.Aop`` of the assembled affine operator before each solve."""
    cfg = {"method": "bicgstab", "tol": 1e-10, "max_it": 400}
    faces = (["dirichlet", "neumann", "neumann", "dirichlet", "dirichlet", "dirichlet"],
             [0.0, 0.1, 0.0, 0.0, 0.0, 0.0])
    jv, pv, jr, pr = _transient_pair((8, 9, 7), faces, 9)
    adv = 1.0 + 0.3 * np.random.default_rng(10).standard_normal((1, 8, 9, 7))
    js, ps = JSolver({"fdm": dict(cfg)}), Solver({"fdm": dict(cfg)})
    for var in (jv, pv):
        var.set_time(0.05, 0.0)
    for _ in range(3):
        for var, s, fdm, rhs, a in ((jv, js, JFDM({"div": {"limiter": "upwind"}}), jr,
                                     jnp.asarray(adv)),
                                    (pv, ps, FDM({"div": {"limiter": "upwind"}}), pr, adv)):
            var.save_old()
            s.set_eq(_eq(fdm, var, rhs, adv=a, scheme=scheme))
        assert _rel(ps.Aop(pv).numpy(), js.Aop(jv)) <= 1e-12
        js.solve()
        ps.solve()
        assert ps.report["itr"] == js.report["itr"]
        assert _rel(pv().numpy(), jv()) <= 1e-10
        for var in (jv, pv):
            var.update_time()


def test_periodic_bc_and_history_carry():
    """``Periodic`` copies row 0 onto the duplicate seam row ``n-1`` (the
    lower face is a no-op), as the JAX BC; ``homogeneous_bcs(...,
    "periodic")`` builds it on every face; history loaded through
    ``field_from_numpy`` counts for BDF2."""
    nx = (6, 7, 5)
    vals = np.random.default_rng(12).standard_normal((2, *nx))
    jm, pm = _meshes(TORUS3, nx)
    jv = JField("u", 2, jm, {"domain": jhomogeneous(3, None, "periodic"), "obstacle": None},
                init_val=jnp.asarray(vals))
    pv = Field("u", 2, pm, {"domain": homogeneous_bcs(3, None, "periodic"), "obstacle": None},
               init_val=vals)
    assert [bc.bc_type for bc in pv.bcs] == ["periodic"] * 6
    for var in (jv, pv):
        var.set_time(0.1, 0.0)
    got = pv.apply_bcs()().numpy()
    assert np.array_equal(got, np.asarray(jv.apply_bcs()()))
    for ax in (1, 2, 3):
        assert np.array_equal(np.take(got, [-1], ax), np.take(got, [0], ax))

    f = Field("c", 1, pm, None)
    field_from_numpy(f, vals[:1], varo=2 * vals[:1], varoo=3 * vals[:1])
    assert f.n_hist == 2 and torch.equal(f.VARoo, torch.from_numpy(3 * vals[:1]))
    f.set_time(0.1, 0.0)
    rec = FDM().ddt(f, "bdf2").ops[0]
    from pyapes_tpu_torch.solver.fdm import ddt_leading_coeff

    assert ddt_leading_coeff(rec) == 1.5


def test_cpu_steps_count_no_launch():
    """On the CPU the advection path runs the plain versions: no kernel
    launch is counted."""
    nx = (6, 7, 8)
    pm = Mesh(Box[TORUS3], None, list(nx), device="cpu", dtype="double")
    rng = np.random.default_rng(13)
    model = pmodels.BurgersND(pm, nu=0.1, init_vals=[rng.standard_normal((1, *nx))
                                                     for _ in range(3)])
    fns = [advect.advect_pair, advect.conv_component, axis_mod.axis_stencil,
           axis_mod.axis_stencil5]
    before = [f.launches for f in fns]
    model.step(0.01)
    assert model.report["converge"]
    assert [f.launches for f in fns] == before
