"""Periodic axes of the port against the JAX package (CPU, float64): the
multigrid hierarchy on the reduced torus and ``PeriodicFlow``.

* The hierarchy (level shapes, ``1/dx^2``, masks, level coefficients,
  symmetrization scales, transfer matrices) is host numpy in both
  packages, built from the same inputs: BIT-equal. One V-cycle and one
  FMG pass agree to 1e-12 relative, constant and variable Γ, both
  transfer modes.
* The Jacobi family's plain versions with every ``mask_axes`` subset (a
  periodic level masks only its other axes) against the JAX Pallas
  kernels in interpret mode: 1e-12 of the output's scale.
* Solves: ``tests/test_multigrid.py::test_mgcg_periodic``'s problem, the
  3-D MG-PCG at 17^3 with 1, 2 and 3 periodic axes (the last singular,
  ``nullspace: "mean"``), a periodic MG-BiCGSTAB advection solve and a
  periodic variable-Γ MG solve: the same ``itr`` and the solutions within
  1e-8; the JAX test's gates where there is one.
* ``PeriodicFlow``: from one carried state the same ``itr`` solve by
  solve and the fields within 1e-8 (Taylor-Green in the default config,
  the skew and advective forms, the Beltrami flow); the gates of
  ``tests/test_models.py``'s Taylor-Green, z-invariant and Beltrami tests
  on the port's own runs (eager; the fused runner: ``tests/test_torch_fuse.py``);
  the obstacle tests of a periodic axis under MG.
"""
from math import exp, pi

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import pyapes_tpu.models as jmodels  # noqa: E402
from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.ops.pallas_stencil import pallas_jacobi3d  # noqa: E402
from pyapes_tpu.ops.pallas_stencil_db import pallas_jacobi3d_dot_db  # noqa: E402
from pyapes_tpu.ops.pallas_stencil_v3 import pallas_jacobi3d_x2  # noqa: E402
from pyapes_tpu.solver import FDM as JFDM  # noqa: E402
from pyapes_tpu.solver import Solver as JSolver  # noqa: E402
from pyapes_tpu.solver import multigrid as jmg  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu.variables.bcs import ObstacleDirichlet as JObstacleDirichlet  # noqa: E402
from pyapes_tpu.variables.bcs import mixed_bcs as jmixed  # noqa: E402
import pyapes_tpu_torch.models as pmodels  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops import jacobi  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.solver import multigrid as pmg  # noqa: E402
from pyapes_tpu_torch.solver.linalg import dispatch as dispatch_mod  # noqa: E402
from pyapes_tpu_torch.utils.carry import model_state_from_numpy  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import ObstacleDirichlet, mixed_bcs  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

D = ("dirichlet", "dirichlet")
N = ("neumann", "neumann")
# (shape on the torus, periodic axes, face kinds): one, two and three
# periodic axes, Neumann off the torus, a 2-D grid, odd torus sizes
HIER = {
    "x": ((16, 17, 17), (0,), None),
    "xy": ((16, 16, 17), (0, 1), None),
    "xyz": ((16, 16, 16), (0, 1, 2), None),
    "xz_neumann": ((16, 9, 16), (0, 2), (D, ("neumann", "dirichlet"), D)),
    "y_neumann_singular": ((9, 16, 9), (1,), (N, D, N)),
    "x_2d": ((32, 17), (0,), None),
    "odd_torus": ((15, 12, 9), (0, 1), None),
}
LENGTHS = [1.0, 2.0, 0.5]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _pair(case, transfers="strided", **opts):
    shape, paxes, fk = HIER[case]
    lengths = LENGTHS[: len(shape)]
    j = jmg.MGSpec(shape, lengths, paxes=paxes, dtype=jnp.float64, face_kinds=fk,
                   transfers=transfers, **opts)
    p = pmg.MGSpec(shape, lengths, paxes=paxes, dtype=torch.float64, face_kinds=fk,
                   transfers=transfers, device="cpu", **opts)
    return j, p


@pytest.mark.parametrize("case", sorted(HIER))
def test_periodic_hierarchy_bit_equal(case):
    j, p = _pair(case)
    assert p.paxes == j.paxes and p.shapes == j.shapes
    assert p._surgery == j._surgery and p._singular == j._singular
    for shape in j.shapes:
        assert p._inv_dx2(shape) == j._inv_dx2(shape)
        assert p._mask_axes(shape) == j._mask_axes(shape)
        assert np.array_equal(_np(p._mask(shape))[0], np.asarray(j._mask(shape)))
        for jc, pc in zip(j._level_coeffs(shape, jnp.float64), p._level_coeffs_np(shape)):
            for a, b in zip(jc, pc):
                assert np.array_equal(np.asarray(a), b)
        for ax, n in enumerate(shape):
            assert np.array_equal(j._dvec_np(n, ax), p._dvec_np(n, ax))
    for fine, coarse in zip(j.shapes, j.shapes[1:]):
        for ax, (nf, nc) in enumerate(zip(fine, coarse)):
            assert p._strided_ok(nf, nc, ax) == j._strided_ok(nf, nc, ax)
            assert np.array_equal(jmg._interp_matrix_periodic_np(nc, nf),
                                  pmg._interp_matrix_periodic_np(nc, nf))
            for ns, nt in ((nf, nc), (nc, nf)):
                assert np.array_equal(j._transfer_matrix_np(ns, nt, ax),
                                      p._transfer_matrix_np(ns, nt, ax))


def test_mg_spec_key_holds_the_periodic_axes():
    a = pmg.MGSpec((16, 16, 17), LENGTHS, paxes=(0, 1), device="cpu")
    b = pmg.MGSpec((16, 16, 17), LENGTHS, device="cpu")
    assert a.key != b.key and a.paxes == (0, 1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("transfers", ["strided", "matrix"])
@pytest.mark.parametrize("case", sorted(HIER))
def test_periodic_vcycle_and_fmg_match_jax(case, transfers):
    j, p = _pair(case, transfers)
    r = np.random.default_rng(sorted(HIER).index(case)).standard_normal((1,) + HIER[case][0])
    z_j = j.preconditioner()(jnp.asarray(r))
    z_p = p.preconditioner()(torch.from_numpy(r))
    assert _rel(_np(z_p), z_j) <= 1e-12
    assert _rel(_np(p.fmg(torch.from_numpy(r))), j.fmg(jnp.asarray(r))) <= 1e-12


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("case", ["xy", "xyz", "xz_neumann", "x_2d"])
def test_periodic_variable_gamma_vcycle_matches_jax(case, stacked):
    j, p = _pair(case, var_gamma=True)
    shape = HIER[case][0]
    rng = np.random.default_rng(5)
    g = np.exp(0.4 * rng.standard_normal(((len(shape),) if stacked else ()) + shape))
    r = rng.standard_normal((1,) + shape)
    j.set_gamma(jnp.asarray(g))
    p.set_gamma(torch.from_numpy(g))
    for lvl, _ in enumerate(j.shapes):
        assert _rel(_np(p._g_levels[lvl]), j._g_levels[lvl]) <= 1e-14
    assert _rel(_np(p.preconditioner()(torch.from_numpy(r))),
                j.preconditioner()(jnp.asarray(r))) <= 1e-12


# -- the Jacobi family with every mask_axes subset -----------------------------

SUBSETS = [(), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2), (0, 1, 2)]
PALLAS_SHAPE = (1, 16, 16, 128)


def _level(seed):
    shape = PALLAS_SHAPE
    rng = np.random.default_rng(seed)
    inv = tuple(float(n**2) for n in shape[1:])  # a torus level's 1/dx^2
    beta = 0.857 / (-2.0 * sum(inv))
    x = rng.standard_normal(shape)
    b = sum(inv) * rng.standard_normal(shape)
    return inv, beta, x, b


def _close(got, want, scale=None):
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    assert np.abs(np.asarray(got) - want).max() <= 1e-12 * scale


@pytest.mark.parametrize("axes", SUBSETS)
def test_jacobi_family_mask_subsets_vs_pallas(axes):
    """``jacobi3d`` (smooth and residual), ``jacobi3d_dot`` and
    ``jacobi3d_x2`` (from zero, emitting the dot) with ``mask_axes``
    ``axes``: the torus wrap on every axis, the update zeroed on the end
    rows of ``axes`` only."""
    inv, beta, x, b = _level(11)
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    jx, jb = jnp.asarray(x), jnp.asarray(b)
    for alpha, bt in ((1.0, beta), (0.0, 1.0)):
        _close(_np(jacobi.jacobi3d(tx, tb, inv, alpha, bt, axes)),
               pallas_jacobi3d(jx, jb, inv, alpha, bt, axes, interpret=True))
    out, dot = jacobi.jacobi3d_dot(tx, tb, inv, 1.0, beta, axes)
    jout, jdot = pallas_jacobi3d_dot_db(jx, jb, inv, 1.0, beta, axes, interpret=True)
    _close(_np(out), jout)
    _close(_np(dot).reshape(-1), jdot, scale=np.abs(b * np.asarray(jout)).sum())
    z, zdot = jacobi.jacobi3d_x2(None, tb, inv, beta, axes, from_zero=True, emit_dot=True)
    jz, jzdot = pallas_jacobi3d_x2(None, jb, inv, beta, axes, from_zero=True, emit_dot=True,
                                   interpret=True)
    _close(_np(z), jz)
    _close(_np(zdot), jzdot, scale=np.abs(b * np.asarray(jz)).sum())
    _close(_np(jacobi.jacobi3d_x2(tx, tb, inv, beta, axes)),
           pallas_jacobi3d_x2(jx, jb, inv, beta, axes, interpret=True))


# -- periodic solves ------------------------------------------------------------

def _meshes(nx, obstacles=None, length=1.0):
    box = tuple(slice(0, length) for _ in nx)
    return (JMesh(JBox[box], None if obstacles is None else [JBox[o] for o in obstacles],
                  list(nx), dtype="double"),
            Mesh(Box[box], None if obstacles is None else [Box[o] for o in obstacles],
                 list(nx), device="cpu", dtype="double"))


def _bcs(kinds):
    """Both packages' BC lists of per-face ``kinds`` (value 0 off the
    periodic faces)."""
    vals = [None if k == "periodic" else 0.0 for k in kinds]
    return jmixed(vals, list(kinds)), mixed_bcs(vals, list(kinds))


def _solve_both(nx, kinds, cfg, lhs, rhs, obstacle=None, fdm_cfg=None):
    """One solve of ``lhs(fdm, var) == rhs`` through both packages (their
    ``FDM(fdm_cfg)``): ``(jax report, jax values, port report, port
    values)``."""
    jm, pm = _meshes(nx)
    jb, pb = _bcs(kinds)
    jv = JField("p", 1, jm, {"domain": jb, "obstacle": obstacle}, init_val=0.0)
    pv = Field("p", 1, pm, {"domain": pb, "obstacle": obstacle}, init_val=0.0)
    js, ps = JSolver({"fdm": dict(cfg)}), Solver({"fdm": dict(cfg)})
    js.set_eq(lhs(JFDM(fdm_cfg), jv) == jnp.asarray(rhs))
    ps.set_eq(lhs(FDM(fdm_cfg), pv) == torch.as_tensor(rhs))
    return js.solve(), np.asarray(jv()), ps.solve(), _np(pv())


def _same(jrep, jx, prep, px, tol=1e-8):
    assert prep["itr"] == jrep["itr"], (prep, jrep)
    assert prep["converge"] and jrep["converge"]
    assert np.abs(px - jx).max() <= tol * max(1.0, np.abs(jx).max())


MGCG = {"method": "cg", "tol": 1e-8, "max_it": 3000, "report": False, "criterion": "residual"}
PER_X = ["periodic", "periodic", "dirichlet", "dirichlet"]


def test_mgcg_periodic():
    """``tests/test_multigrid.py::test_mgcg_periodic`` (65^2, periodic x,
    Dirichlet y, random RHS): MG-PCG against plain CG in both packages."""
    n = 65
    rhs = np.random.default_rng(1).standard_normal((1, n, n))
    lap = lambda f, v: f.laplacian(1.0, v)  # noqa: E731
    jref, jx_ref, pref, px_ref = _solve_both((n, n), PER_X, MGCG, lap, rhs)
    jrep, jx, prep, px = _solve_both((n, n), PER_X, {**MGCG, "precond": "mg"}, lap, rhs)
    _same(jref, jx_ref, pref, px_ref)
    _same(jrep, jx, prep, px)
    assert prep["itr"] < pref["itr"] / 3
    assert_allclose(px[0], px_ref[0], atol=1e-6)
    assert np.abs(px - jx).max() <= MGCG["tol"]


@pytest.mark.parametrize("n_per", [1, 2, 3])
def test_mgpcg_3d_periodic_axes(n_per):
    """A 17^3 MG-PCG with the first ``n_per`` axes periodic (all three: the
    singular torus, ``nullspace: "mean"`` and a zero-mean RHS)."""
    n = 17
    kinds = ["periodic"] * (2 * n_per) + ["dirichlet"] * (6 - 2 * n_per)
    rhs = np.random.default_rng(20 + n_per).standard_normal((1, n, n, n))
    cfg = {**MGCG, "precond": "mg", "tol": 1e-10}
    if n_per == 3:
        rhs -= rhs[:, :-1, :-1, :-1].mean()
        cfg["nullspace"] = "mean"
    lap = lambda f, v: f.laplacian(1.0, v)  # noqa: E731
    jrep, jx, prep, px = _solve_both((n, n, n), kinds, cfg, lap, rhs)
    _same(jrep, jx, prep, px)
    assert prep["itr"] <= 20
    for j in range(n_per):  # the duplicate seam plane restored
        assert np.array_equal(px.take(0, axis=1 + j), px.take(-1, axis=1 + j))


def test_mg_bicgstab_periodic_advection():
    """A nonsymmetric upwind advection-diffusion system on a periodic-x
    channel (``tests/test_multigrid.py::test_mg_bicgstab_advection_diffusion``
    with a periodic axis), BiCGSTAB preconditioned by the torus V-cycle.

    BiCGSTAB on this system amplifies a rounding difference ~10x per
    iteration in either package (the two residual histories part at 1e-7
    by iteration 8, as they do on the all-Dirichlet system; unpreconditioned
    they stay within 3e-5 over 117 iterations), so the two packages may
    stop one iteration apart at the tolerance: ``|d itr| <= 1``, both
    converged, the solutions within the tolerance."""
    n = 33
    rhs = np.random.default_rng(2).standard_normal((1, n, n))
    cfg = {"method": "bicgstab", "tol": 1e-9, "max_it": 3000, "report": False}
    lhs = lambda f, v: f.div(1.0, v) - f.laplacian(0.05, v)  # noqa: E731
    fdm_cfg = {"div": {"limiter": "upwind", "edge": False}}
    jref, jx_ref, pref, px_ref = _solve_both((n, n), PER_X, cfg, lhs, rhs, fdm_cfg=fdm_cfg)
    _same(jref, jx_ref, pref, px_ref)
    jrep, jx, prep, px = _solve_both((n, n), PER_X, {**cfg, "precond": "mg"}, lhs, rhs,
                                     fdm_cfg=fdm_cfg)
    assert abs(prep["itr"] - jrep["itr"]) <= 1 and prep["converge"] and jrep["converge"]
    assert np.abs(px - jx).max() <= cfg["tol"] * np.abs(jx).max()
    assert prep["itr"] < pref["itr"]
    assert_allclose(px, px_ref, atol=1e-6)


def test_periodic_variable_gamma_mg_solve():
    """A 9^3 ``ddt - laplacian(Γ)`` solve, periodic in x and y, Dirichlet
    in z, by CG + MG (the Γ hierarchy on the torus)."""
    n = 9
    rng = np.random.default_rng(3)
    g = np.exp(0.5 * rng.standard_normal((n, n, n)))
    x0 = rng.standard_normal((1, n, n, n))
    cfg = {"method": "cg", "precond": "mg", "tol": 1e-10, "max_it": 500, "report": False,
           "criterion": "residual"}
    jm, pm = _meshes((n, n, n))
    jb, pb = _bcs(["periodic"] * 4 + ["dirichlet"] * 2)
    jv = JField("p", 1, jm, {"domain": jb})
    pv = Field("p", 1, pm, {"domain": pb})
    for v, arr in ((jv, jnp.asarray), (pv, torch.as_tensor)):
        v.set_var_tensor(arr(x0))
        v.apply_bcs()
        v.set_time(0.01, 0.0)
        v.save_old()
    js, ps = JSolver({"fdm": dict(cfg)}), Solver({"fdm": dict(cfg)})
    js.set_eq(JFDM().ddt(jv) - JFDM().laplacian(jnp.asarray(g), jv) == jnp.zeros_like(jv()))
    ps.set_eq(FDM().ddt(pv) - FDM().laplacian(torch.as_tensor(g), pv) == torch.zeros_like(pv()))
    jrep, prep = js.solve(), ps.solve()
    _same(jrep, np.asarray(jv()), prep, _np(pv()))
    assert prep["itr"] <= 20, prep


# -- PeriodicFlow ----------------------------------------------------------------

def _record_itr(model, out: list) -> None:
    for solver in (model.mom_solver, model.p_solver):
        real = solver.solve

        def solve(real=real):
            rep = real()
            out.append(rep["itr"])
            return rep

        solver.solve = solve


def _state(model) -> list:
    return [(_np(f()), _np(f.VARo)) for f in model.state_fields()]


def _max_err(jm, pm) -> float:
    return max(np.abs(_np(a()) - _np(b())).max()
               for a, b in zip(jm.state_fields(), pm.state_fields()))


def _tg(mesh_np):
    k = 2 * pi
    X, Y = mesh_np[0], mesh_np[1]
    return -np.cos(k * X) * np.sin(k * Y), np.sin(k * X) * np.cos(k * Y)


def _beltrami(mesh_np):
    X, Y, Z = mesh_np
    return np.sin(Z) + np.cos(Y), np.sin(X) + np.cos(Z), np.sin(Y) + np.cos(X)


# (grid, box length, nu, dt, initial field, model kwargs, config)
FLOWS = {
    "tg_2d_default": ((17, 17), 1.0, 0.01, 2e-3, _tg, {}, None),
    "tg_2d_krylov": ((17, 17), 1.0, 0.01, 2e-3, _tg, {}, {"method": "bicgstab",
                                                          "precond": None}),
    "tg_2d_skew": ((17, 17), 1.0, 0.01, 2e-3, _tg, {"advection_form": "skew"}, None),
    "tg_2d_advective": ((17, 17), 1.0, 0.01, 2e-3, _tg, {"advection_form": "advective"}, None),
    "tg_2d_chorin_implicit": ((17, 17), 1.0, 0.01, 2e-3, _tg,
                              {"incremental": False, "implicit_advection": True}, None),
    "beltrami_3d": ((9, 9, 9), 2 * pi, 0.2, 0.05, _beltrami, {}, None),
}


@pytest.mark.parametrize("case", sorted(FLOWS))
def test_periodic_flow_same_solves_as_jax(case):
    """One JAX step from the initial field, the state carried over, then 5
    steps in both: the same ``itr`` solve by solve, the fields within
    1e-8, the same kinetic energy."""
    nx, length, nu, dt, init, kw, cfg = FLOWS[case]
    jmesh, pmesh = _meshes(nx, length=length)
    jm = jmodels.PeriodicFlow(jmesh, nu=nu, config=cfg, **kw)
    pm = pmodels.PeriodicFlow(pmesh, nu=nu, config=cfg, **kw)
    assert pm.advection_form == jm.advection_form
    u0 = init([np.asarray(g) for g in jmesh._grid_np])
    jm.set_velocity(*[jnp.asarray(a) for a in u0])
    jm.run(dt, 1)
    model_state_from_numpy(pm, _state(jm), t=jm.t)
    jitr, pitr = [], []
    _record_itr(jm, jitr)
    _record_itr(pm, pitr)
    jm.run(dt, 5)
    pm.run(dt, 5)
    assert pitr == jitr and len(pitr) == 5 * (len(nx) + 1)
    assert _max_err(jm, pm) <= 1e-8
    assert abs(float(pm.kinetic_energy()) - float(jm.kinetic_energy())) <= 1e-10


def test_periodic_flow_set_velocity_matches_jax():
    jmesh, pmesh = _meshes((9, 9, 9), length=2 * pi)
    jm, pm = jmodels.PeriodicFlow(jmesh), pmodels.PeriodicFlow(pmesh)
    u0 = _beltrami([np.asarray(g) for g in jmesh._grid_np])
    jm.set_velocity(*[jnp.asarray(a) for a in u0])
    pm.set_velocity(*u0)
    assert _max_err(jm, pm) == 0.0
    assert abs(float(pm.kinetic_energy()) - float(jm.kinetic_energy())) <= 1e-12
    assert pm._rc_mask.all() and pm._singular_pressure
    assert pm.p_solver.config["fdm"]["nullspace"] == "mean"


def _port_flow(nx, nu, **kw):
    box = tuple(slice(0, 1) for _ in nx)
    mesh = Mesh(Box[box], None, list(nx), device="cpu", dtype="double")
    return mesh, pmodels.PeriodicFlow(mesh, nu=nu, **kw)


def test_taylor_green_decay():
    """``tests/test_models.py::test_taylor_green_decay``: 65^2, 50 steps."""
    mesh, model = _port_flow((65, 65), 0.01)
    k = 2 * pi
    u0 = -torch.cos(k * mesh.X) * torch.sin(k * mesh.Y)
    v0 = torch.sin(k * mesh.X) * torch.cos(k * mesh.Y)
    model.set_velocity(u0, v0)
    dt, steps = 2e-3, 50
    model.run(dt, steps)
    decay = exp(-2 * k**2 * 0.01 * dt * steps)
    u, v = _np(model.u()[0]), _np(model.v()[0])
    u_ex, v_ex = _np(u0) * decay, _np(v0) * decay
    rel_u = np.linalg.norm(u - u_ex) / np.linalg.norm(u_ex)
    rel_v = np.linalg.norm(v - v_ex) / np.linalg.norm(v_ex)
    assert rel_u < 0.01 and rel_v < 0.01, (rel_u, rel_v)
    ke = float(model.kinetic_energy())
    assert abs(ke / (0.25 * decay**2) - 1.0) < 0.02, ke
    assert np.abs(_np(model.divergence())).max() < 0.05


def test_taylor_green_3d_z_invariant():
    """``test_models.py::test_taylor_green_3d_z_invariant``: 33 x 33 x 9,
    20 steps, tol 1e-9."""
    mesh, model = _port_flow((33, 33, 9), 0.01, config={"tol": 1e-9})
    k = 2 * pi
    u0 = -torch.cos(k * mesh.X) * torch.sin(k * mesh.Y)
    v0 = torch.sin(k * mesh.X) * torch.cos(k * mesh.Y)
    model.set_velocity(u0, v0, torch.zeros_like(u0))
    dt, steps = 2e-3, 20
    model.run(dt, steps)
    decay = exp(-2 * k**2 * 0.01 * dt * steps)
    u, w = _np(model.u()[0]), _np(model.w()[0])
    u_ex = _np(u0) * decay
    assert np.linalg.norm(u - u_ex) / np.linalg.norm(u_ex) < 0.02
    assert np.abs(w).max() < 1e-6, np.abs(w).max()


def test_beltrami_abc_decay_3d_anchor():
    """``test_models.py::test_beltrami_abc_decay_3d_anchor`` at 17^3: the
    exact ``u0 e^{-nu t}`` decay and the energy ``E0 e^{-2 nu t}``."""
    L, nu, t_end, n = 2 * pi, 0.2, 0.5, 17
    mesh = Mesh(Box[0:L, 0:L, 0:L], None, [n, n, n], device="cpu", dtype="double")
    model = pmodels.PeriodicFlow(mesh, nu=nu)
    u0 = _beltrami([_np(g) for g in (mesh.X, mesh.Y, mesh.Z)])
    model.set_velocity(*u0)
    E0 = float(model.kinetic_energy())
    h = L / (n - 1)
    steps = int(round(t_end / (0.2 * h / 2.0)))
    model.run(t_end / steps, steps)
    dec = np.exp(-nu * model.t)
    num = den = 0.0
    for j, e0 in enumerate(u0):
        ue = _np(e0) * dec
        num += float(np.sum((_np(model.vel[j]()[0]) - ue) ** 2))
        den += float(np.sum(ue**2))
    err = np.sqrt(num / den)
    assert err < 3.0e-3, err
    assert abs(float(model.kinetic_energy()) / E0 - dec**2) < 4e-3


# -- obstacles on a periodic axis, under MG ------------------------------------------

OBS_MG = {"method": "cg", "precond": "mg", "tol": 1e-11, "max_it": 5000, "report": False,
          "criterion": "residual"}


def test_obstacle_with_periodic_axis_mg():
    """``tests/test_obstacle.py::test_obstacle_with_periodic_axis`` with
    ``precond: "mg"``: a hot body in a channel periodic along x."""
    n = 33
    jm, pm = _meshes((n, n), obstacles=[(slice(0.4, 0.6), slice(0.4, 0.6))])
    jb, pb = _bcs(PER_X)
    obs = [{"bc_type": "dirichlet", "bc_val": 1.0}]
    jv = JField("p", 1, jm, {"domain": jb, "obstacle": obs})
    pv = Field("p", 1, pm, {"domain": pb, "obstacle": obs})
    js, ps = JSolver({"fdm": dict(OBS_MG)}), Solver({"fdm": dict(OBS_MG)})
    js.set_eq(JFDM().laplacian(1.0, jv) == jnp.zeros_like(jv()))
    ps.set_eq(FDM().laplacian(1.0, pv) == torch.zeros_like(pv()))
    jrep, prep = js.solve(), ps.solve()
    _same(jrep, np.asarray(jv()), prep, _np(pv()))
    v = _np(pv()[0])
    assert np.all(np.isfinite(v))
    assert_allclose(v[0, :], v[-1, :], atol=1e-12)
    assert v.max() <= 1.0 + 1e-9 and v.min() >= -1e-9
    shell = np.zeros((n, n), dtype=bool)
    for m in pm.o_mask[0].values():
        shell |= m
    assert_allclose(v[shell], 1.0, atol=1e-12)


def test_dynamic_obstacle_with_periodic_axis_mg():
    """``test_obstacle.py::test_dynamic_obstacle_with_periodic_axis`` with
    ``precond: "mg"``: a body walking along the torus, the same ``itr`` as
    the JAX package at every position, the streamed solve equal to a
    static one."""
    n = 33
    jm, pm = _meshes((n, n))
    jb, pb = _bcs(PER_X)
    cfg = {**OBS_MG, "tol": 1e-12}

    def body_at(shift):
        m = np.zeros((n, n), dtype=bool)
        for c in [(8 + shift + k) % (n - 1) for k in range(5)]:
            m[c, 14:19] = True
        return m

    def solve_static(mask):
        var = Field("p", 1, pm, {"domain": pb})
        var.bcs.append(ObstacleDirichlet("body", 1.0, mask))
        s = Solver({"fdm": dict(cfg)})
        s.set_eq(FDM().laplacian(1.0, var) == torch.zeros_like(var()))
        s.solve()
        return _np(var()[0])

    var = Field("p", 1, pm, {"domain": pb})
    obc = ObstacleDirichlet("body", 1.0, body_at(0), dynamic=True)
    var.bcs.append(obc)
    jvar = JField("p", 1, jm, {"domain": jb})
    jobc = JObstacleDirichlet("body", 1.0, body_at(0), dynamic=True)
    jvar.bcs.append(jobc)
    s, js = Solver({"fdm": dict(cfg)}), JSolver({"fdm": dict(cfg)})
    dispatch_mod.clear_cache()
    for shift in (0, 7, 15):
        obc.bc_mask = jobc.bc_mask = body_at(shift)
        s.set_eq(FDM().laplacian(1.0, var) == torch.zeros_like(var()))
        js.set_eq(JFDM().laplacian(1.0, jvar) == jnp.zeros_like(jvar()))
        rep, jrep = s.solve(), js.solve()
        _same(jrep, np.asarray(jvar()), rep, _np(var()), tol=1e-10)
        v = _np(var()[0])
        assert_allclose(v[0, :], v[-1, :], atol=1e-12)
        assert_allclose(v, solve_static(body_at(shift)), atol=1e-9)
        assert_allclose(v[body_at(shift)], 1.0, atol=1e-9)
        assert v.max() <= 1.0 + 1e-9 and v.min() >= -1e-9
    assert len(dispatch_mod._MG_CACHE) == 1
