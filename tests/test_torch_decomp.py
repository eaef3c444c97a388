"""The decomposed solves of the port against the JAX package (CPU, float64):
each solve of ``tests/test_sharding.py`` runs in three ways on the same
numpy inputs: the port with the decomposition, the JAX package with it (8
virtual CPU devices, conftest) and the JAX package on one device; the CG,
BiCGSTAB and MG-PCG cases also run through the port on a placed
decomposition (``devices=("cpu",) * n``: each block its own allocation,
``PLACED_CASES``), held to the same two JAX solves with the case's gates. The
decomposed ``PeriodicFlow`` (5 Taylor-Green steps) runs through the port
with and without the decomposition and through the JAX package on one
device.

Gates, per the JAX test: where it asks for equality with the single-device
solve, the same ``itr`` and agreement to 1e-10 (both packages run the same
f64 arithmetic in another summation order; the block-wise apply adds the
same products in the same order as the global one); where it allows an
``itr`` spread (MG with the sharded levels) or compares the solutions only
(the BiCGSTAB solves at tol 1e-9 / 1e-10, where the JAX package's own
decomposed and single-device runs differ by one iteration),
``|d itr| <= 2`` and its tolerance. Beside them: the 3-D decomposed CG,
fastdiag and MG solves go through the halo-extended kernel's wrapper
(counted through its plain version), and a split of the last axis does
not.
"""
from math import pi
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.parallel import DomainDecomposition as JDD  # noqa: E402
from pyapes_tpu.solver.fdm import FDM as JFDM  # noqa: E402
from pyapes_tpu.solver.ops import Solver as JSolver  # noqa: E402
from pyapes_tpu.testing import poisson as jpoisson  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu.variables import bcs as jbcs  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops import axis_stencil as axis_mod  # noqa: E402
from pyapes_tpu_torch.parallel import DomainDecomposition  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.testing import poisson as ppoisson  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables import bcs as pbcs  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

JAX = SimpleNamespace(Box=JBox, Mesh=lambda b, nx: JMesh(b, None, nx, dtype="double"),
                      Field=JField, FDM=JFDM, Solver=JSolver, DD=JDD, arr=jnp.asarray,
                      bcs=jbcs, poisson=jpoisson, out=np.asarray)
PORT = SimpleNamespace(Box=Box, Mesh=lambda b, nx: Mesh(b, None, nx, device="cpu",
                                                        dtype="double"),
                       Field=Field, FDM=FDM, Solver=Solver, DD=DomainDecomposition,
                       arr=torch.from_numpy, bcs=pbcs, poisson=ppoisson,
                       out=lambda t: t.numpy())
PLACED = SimpleNamespace(**{**vars(PORT), "DD": lambda ms: DomainDecomposition(
    ms, devices=("cpu",) * int(np.prod(ms)))})
U2, U3 = (slice(0, 1),) * 2, (slice(0, 1),) * 3


def _solve(P, decomp, mesh, var, lhs, rhs, cfg):
    if decomp is not None:
        cfg = {**cfg, "decomp": P.DD(decomp)}
    s = P.Solver({"fdm": {"report": False, **cfg}})
    s.set_eq(lhs == rhs)
    rep = s.solve()
    return P.out(var()[0]), rep


def poisson2d(P, decomp, method="cg"):
    mesh = P.Mesh(P.Box[U2], [64, 64])
    var = P.Field("p", 1, mesh, {"domain": P.poisson.poisson_bcs(2), "obstacle": None})
    rhs = P.poisson.poisson_rhs_nd(mesh, var)
    cfg = ({"method": "cg", "tol": 1e-8, "max_it": 2000} if method == "cg"
           else {"method": "fastdiag", "tol": 1e-10, "max_it": 50})
    return _solve(P, decomp, mesh, var, P.FDM().laplacian(1.0, var), rhs, cfg)


def periodic2d(P, decomp):
    mesh = P.Mesh(P.Box[U2], [33, 32])
    bc = P.bcs.mixed_bcs([None, None, 0, 0], ["periodic", "periodic", "dirichlet", "dirichlet"])
    var = P.Field("p", 1, mesh, {"domain": bc, "obstacle": None}, init_val=0.0)
    X, Y = np.meshgrid(np.linspace(0, 1, 33), np.linspace(0, 1, 32), indexing="ij")
    rhs = P.arr((np.sin(2 * pi * X) * np.sin(pi * Y))[None])
    cfg = {"method": "bicgstab", "tol": 1e-10, "max_it": 2000}
    return _solve(P, decomp, mesh, var, -P.FDM().laplacian(var), rhs, cfg)


def poisson3d(P, decomp):
    mesh = P.Mesh(P.Box[U3], [16, 16, 16])
    var = P.Field("p", 1, mesh, {"domain": P.poisson.poisson_bcs(3), "obstacle": None})
    rhs = P.poisson.poisson_rhs_nd(mesh, var)
    cfg = {"method": "cg", "tol": 1e-8, "max_it": 2000}
    return _solve(P, decomp, mesh, var, P.FDM().laplacian(1.0, var), rhs, cfg)


def _random_dirichlet(P, decomp, nx, seed, cfg):
    mesh = P.Mesh(P.Box[(slice(0, 1),) * len(nx)], list(nx))
    var = P.Field("p", 1, mesh,
                  {"domain": P.bcs.homogeneous_bcs(len(nx), 0.0, "dirichlet"), "obstacle": None},
                  init_val=0.0)
    rhs = P.arr(np.random.default_rng(seed).standard_normal((1, *nx)))
    return _solve(P, decomp, mesh, var, P.FDM().laplacian(1.0, var), rhs,
                  {"criterion": "residual", **cfg})


def mgcg2d(P, decomp):
    return _random_dirichlet(P, decomp, (64, 64), 0,
                             {"method": "cg", "tol": 1e-8, "max_it": 500, "precond": "mg"})


def mixed3d(P, decomp):
    mesh = P.Mesh(P.Box[U3], [17, 16, 16])
    bc = P.bcs.mixed_bcs([0.5, 0.0, None, None, None, None],
                         ["neumann", "dirichlet", "periodic", "periodic", "symmetry", "symmetry"])
    var = P.Field("p", 1, mesh, {"domain": bc, "obstacle": None}, init_val=0.0)
    r = np.random.default_rng(7).standard_normal((1, 17, 16, 16))
    cfg = {"method": "bicgstab", "tol": 1e-9, "max_it": 3000}
    return _solve(P, decomp, mesh, var, P.FDM().laplacian(1.0, var), P.arr(r - r.mean()), cfg)


def sharded_cg(P, decomp):
    return _random_dirichlet(P, decomp, (16, 16, 128), 5,
                             {"method": "cg", "tol": 1e-10, "max_it": 600})


def sharded_mg(P, decomp):
    return _random_dirichlet(P, decomp, (16, 16, 128), 9,
                             {"method": "cg", "tol": 1e-9, "max_it": 300, "precond": "mg",
                              "mg_opts": {"n_pre": 1, "n_post": 1}})


def sharded_fastdiag(P, decomp):
    return _random_dirichlet(P, decomp, (16, 16, 128), 3,
                             {"method": "fastdiag", "tol": 1e-10, "max_it": 50})


def neumann_fastdiag(P, decomp):
    """All-Neumann 2-D fastdiag on the zero-mean quotient space (the
    pseudo-inverse eigen-solve, the 3/2 row scale's null vector)."""
    mesh = P.Mesh(P.Box[U2], [32, 32])
    var = P.Field("p", 1, mesh, {"domain": P.bcs.homogeneous_bcs(2, 0.0, "neumann"),
                                 "obstacle": None}, init_val=0.0)
    r = np.random.default_rng(8).standard_normal((1, 32, 32))
    cfg = {"method": "fastdiag", "tol": 1e-10, "max_it": 50, "nullspace": "mean"}
    return _solve(P, decomp, mesh, var, P.FDM().laplacian(1.0, var), P.arr(r - r.mean()), cfg)


def periodic_fastdiag(P, decomp):
    """``periodic2d``'s torus (axis 0 periodic) through fastdiag: a
    circulant axis, every torus node active."""
    mesh = P.Mesh(P.Box[U2], [33, 32])
    bc = P.bcs.mixed_bcs([None, None, 0, 0], ["periodic", "periodic", "dirichlet", "dirichlet"])
    var = P.Field("p", 1, mesh, {"domain": bc, "obstacle": None}, init_val=0.0)
    X, Y = np.meshgrid(np.linspace(0, 1, 33), np.linspace(0, 1, 32), indexing="ij")
    rhs = P.arr((np.sin(2 * pi * X) * np.sin(pi * Y) + 0.1 * X * Y)[None])
    cfg = {"method": "fastdiag", "tol": 1e-10, "max_it": 50}
    return _solve(P, decomp, mesh, var, -P.FDM().laplacian(var), rhs, cfg)


def fd_precond(P, decomp, method, nx, seed, kinds=None):
    """CG or BiCGSTAB preconditioned by the fast-diagonalization solve on a
    seeded random RHS (``kinds``: the faces, value 0; Neumann and Symmetry
    faces put CG's 3/2 row scale in front of the eigen-solve)."""
    mesh = P.Mesh(P.Box[(slice(0, 1),) * len(nx)], list(nx))
    bc = (P.bcs.homogeneous_bcs(len(nx), 0.0, "dirichlet") if kinds is None
          else P.bcs.mixed_bcs([0.0] * len(kinds), kinds))
    var = P.Field("p", 1, mesh, {"domain": bc, "obstacle": None}, init_val=0.0)
    rhs = P.arr(np.random.default_rng(seed).standard_normal((1, *nx)))
    cfg = {"method": method, "tol": 1e-10, "max_it": 100, "criterion": "residual",
           "precond": "fd"}
    return _solve(P, decomp, mesh, var, P.FDM().laplacian(1.0, var), rhs, cfg)


MIXED_FACES = ["neumann", "dirichlet", "symmetry", "dirichlet", "dirichlet", "neumann"]


def sharded2d(P, decomp):
    return _random_dirichlet(P, decomp, (32, 128), 12,
                             {"method": "cg", "tol": 1e-10, "max_it": 900})


def advect(P, decomp, limiter, op):
    mesh = P.Mesh(P.Box[U3], [16, 16, 128])
    bc = P.bcs.mixed_bcs([0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
                         ["dirichlet", "neumann", "dirichlet", "dirichlet", "neumann", "dirichlet"])
    var = P.Field("p", 1, mesh, {"domain": bc, "obstacle": None}, init_val=0.0)
    advv = P.arr(np.random.default_rng(11).standard_normal(((3 if op == "conv" else 1),
                                                             16, 16, 128)))
    rhs = P.arr(np.random.default_rng(4).standard_normal((1, 16, 16, 128)))
    fdm = P.FDM({"div": {"limiter": limiter, "edge": False}})
    adv = fdm.conv(advv, var) if op == "conv" else fdm.div(advv, var)
    cfg = {"method": "bicgstab", "tol": 1e-10, "max_it": 900, "criterion": "residual"}
    return _solve(P, decomp, mesh, var, adv - fdm.laplacian(1.0, var), rhs, cfg)


def _grid2(n):
    return np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")


def var_gamma(P, decomp):
    n = 64
    mesh = P.Mesh(P.Box[U2], [n, n])
    X, Y = _grid2(n)
    g = 1.0 + X + 2.0 * Y
    phi = np.sin(pi * X) * np.sin(pi * Y)
    px = pi * np.cos(pi * X) * np.sin(pi * Y)
    py = pi * np.sin(pi * X) * np.cos(pi * Y)
    rhs = (-2.0 * pi**2 * g * phi) + px + 2.0 * py
    var = P.Field("t", 1, mesh, {"domain": P.bcs.mixed_bcs([0.0] * 4, ["dirichlet"] * 4)},
                  init_val=0.0)
    cfg = {"method": "cg", "tol": 1e-9, "max_it": 300, "criterion": "residual", "precond": "mg"}
    return _solve(P, decomp, mesh, var, P.FDM().laplacian(P.arr(g), var), P.arr(rhs[None]), cfg)


def stacked_gamma(P, decomp):
    n = 32
    mesh = P.Mesh(P.Box[U2], [n, n])
    X, Y = _grid2(n)
    rhs = ((pi * np.cos(pi * X) - (1.0 + X) * pi**2 * np.sin(pi * X)) * np.sin(pi * Y)
           + (pi * np.cos(pi * Y) - (2.0 + Y) * pi**2 * np.sin(pi * Y)) * np.sin(pi * X))
    var = P.Field("t", 1, mesh, {"domain": P.bcs.mixed_bcs([0.0] * 4, ["dirichlet"] * 4)},
                  init_val=0.0)
    cfg = {"method": "cg", "tol": 1e-9, "max_it": 400, "criterion": "residual"}
    g = (P.arr(1.0 + X), P.arr(2.0 + Y))
    return _solve(P, decomp, mesh, var, P.FDM().laplacian(g, var), P.arr(rhs[None]), cfg)


# (problem, decomposition, JAX config extras of the decomposed run, itr
# slack, atol): the JAX test's decomposition, kernel knob and tolerance
CASES = {
    "cg2d_8x1": (poisson2d, (8, 1), {}, 0, 1e-10),
    "cg2d_1x8": (poisson2d, (1, 8), {}, 0, 1e-10),
    "cg2d_2x4": (poisson2d, (2, 4), {}, 0, 1e-10),
    "cg2d_4x2": (poisson2d, (4, 2), {}, 0, 1e-10),
    "periodic_2x4": (periodic2d, (2, 4), {}, 2, 1e-8),
    "cg3d_2x2x2": (poisson3d, (2, 2, 2), {}, 0, 1e-10),
    "mgcg2d_2x4": (mgcg2d, (2, 4), {}, 0, 1e-12),
    "mixed3d_1x1x2": (mixed3d, (1, 1, 2), {}, 2, 1e-8),
    "sharded_cg_4x2x1": (sharded_cg, (4, 2, 1), {"kernel": "pallas"}, 0, 1e-8),
    "sharded_mg_4x2x1": (sharded_mg, (4, 2, 1), {"kernel": "pallas"}, 2, 1e-7),
    "sharded2d_4x1": (sharded2d, (4, 1), {"kernel": "pallas"}, 0, 1e-8),
    "var_gamma_4x2": (var_gamma, (4, 2), {}, 0, 1e-8),
    "var_gamma_2x4": (var_gamma, (2, 4), {}, 0, 1e-8),
    "stacked_gamma_2x4": (stacked_gamma, (2, 4), {}, 0, 1e-8),
    "fastdiag_8x1": (lambda P, d: poisson2d(P, d, "fastdiag"), (8, 1), {}, 0, 1e-10),
    "fastdiag_2x4": (lambda P, d: poisson2d(P, d, "fastdiag"), (2, 4), {}, 0, 1e-10),
    "sharded_fastdiag_4x2x1": (sharded_fastdiag, (4, 2, 1), {}, 0, 1e-10),
    "neumann_fastdiag_2x4": (neumann_fastdiag, (2, 4), {}, 0, 1e-10),
    "periodic_fastdiag_2x4": (periodic_fastdiag, (2, 4), {}, 0, 1e-10),
    "fd_cg3d_4x2x1": (lambda P, d: fd_precond(P, d, "cg", (16, 16, 32), 5, MIXED_FACES),
                      (4, 2, 1), {}, 0, 1e-10),
    "fd_bicgstab3d_2x2x2": (lambda P, d: fd_precond(P, d, "bicgstab", (16, 16, 16), 6),
                            (2, 2, 2), {}, 0, 1e-10),
    "fd_cg2d_2x4": (lambda P, d: fd_precond(P, d, "cg", (32, 64), 4), (2, 4), {}, 0, 1e-10),
    "fd_bicgstab2d_8x1": (lambda P, d: fd_precond(P, d, "bicgstab", (64, 32), 2), (8, 1), {},
                          0, 1e-10),
}


# the cases the placed decomposition takes (fastdiag, and CG, BiCGSTAB,
# MG-PCG and FD-preconditioned Krylov with constant coefficients; the
# variable-Γ cases raise there)
PLACED_CASES = ("cg2d_8x1", "cg2d_1x8", "cg2d_2x4", "cg2d_4x2", "periodic_2x4", "cg3d_2x2x2",
                "mgcg2d_2x4", "mixed3d_1x1x2", "sharded_cg_4x2x1", "sharded_mg_4x2x1",
                "sharded2d_4x1", "fastdiag_8x1", "fastdiag_2x4", "sharded_fastdiag_4x2x1",
                "neumann_fastdiag_2x4", "periodic_fastdiag_2x4", "fd_cg3d_4x2x1",
                "fd_bicgstab3d_2x2x2", "fd_cg2d_2x4", "fd_bicgstab2d_8x1")


@pytest.mark.parametrize("case", sorted(CASES))
def test_decomposed_solve_vs_jax(case, monkeypatch):
    problem, dd, jax_extra, slack, atol = CASES[case]
    ref, rref = problem(JAX, None)
    real_solver = JAX.Solver
    monkeypatch.setattr(JAX, "Solver", lambda c: real_solver(
        {"fdm": {**c["fdm"], **jax_extra}}))
    jout, jrep = problem(JAX, dd)
    monkeypatch.undo()
    out, rep = problem(PORT, dd)
    assert rep["converge"] and jrep["converge"] and rref["converge"], (rep, jrep, rref)
    assert abs(rep["itr"] - rref["itr"]) <= slack and abs(rep["itr"] - jrep["itr"]) <= slack, \
        (rep, jrep, rref)
    np.testing.assert_allclose(out, ref, atol=atol, rtol=atol)
    np.testing.assert_allclose(out, jout, atol=atol, rtol=atol)
    if case in PLACED_CASES:
        pout, prep = problem(PLACED, dd)
        assert prep["converge"], prep
        assert abs(prep["itr"] - rref["itr"]) <= slack and abs(prep["itr"] - jrep["itr"]) <= slack, \
            (prep, jrep, rref)
        np.testing.assert_allclose(pout, ref, atol=atol, rtol=atol)
        np.testing.assert_allclose(pout, jout, atol=atol, rtol=atol)


@pytest.mark.parametrize("limiter", ["none", "upwind"])
@pytest.mark.parametrize("op", ["div", "conv"])
def test_decomposed_advection_vs_jax(op, limiter, monkeypatch):
    """Implicit Div/Conv under a (2, 2, 1) decomposition: the port's
    block-wise advection apply (the per-point kernels' plain versions plus
    the ghost patches and the rank-gated surgery) against the JAX
    decomposed (``kernel: "pallas"``, as its test) and single-device
    solves, to the JAX test's 2e-7. The JAX test holds no ``itr``: these
    BiCGSTAB solves take 300-400 iterations to tol 1e-10 on a
    nonsymmetric operator, and a change of rounding moves their count."""
    ref, rref = advect(JAX, None, limiter, op)
    real_solver = JAX.Solver
    monkeypatch.setattr(JAX, "Solver", lambda c: real_solver(
        {"fdm": {**c["fdm"], "kernel": "pallas"}}))
    jout, jrep = advect(JAX, (2, 2, 1), limiter, op)
    monkeypatch.undo()
    out, rep = advect(PORT, (2, 2, 1), limiter, op)
    assert rep["tol"] < 1e-9 and jrep["tol"] < 1e-9 and rref["tol"] < 1e-9, (rep, jrep, rref)
    np.testing.assert_allclose(out, ref, atol=2e-7)
    np.testing.assert_allclose(out, jout, atol=2e-7)


@pytest.fixture
def ext_calls(monkeypatch):
    """Counts the calls of the halo-extended kernel's wrapper (on the CPU it
    runs the plain version, so the plain version is wrapped)."""
    calls = []
    real = axis_mod.apply_axis_stencil_ext

    def counted(*args):
        calls.append(tuple(args[1].shape))
        return real(*args)

    monkeypatch.setattr(axis_mod, "apply_axis_stencil_ext", counted)
    return calls


@pytest.mark.parametrize("problem", ["cg", "fastdiag", "mg"])
def test_decomposed_3d_solves_use_the_block_kernel(problem, ext_calls):
    fn = {"cg": sharded_cg, "fastdiag": sharded_fastdiag, "mg": sharded_mg}[problem]
    _, rep = fn(PORT, (4, 2, 1))
    assert rep["converge"]
    # eight blocks of 4 x 8 x 128, each extended by one row on axes 0 and 1
    assert len(ext_calls) >= 8 * rep["itr"] and (1, 6, 10, 128) in ext_calls
    if problem == "mg":  # the coarse levels' blocks too
        assert any(s[3] < 128 for s in ext_calls)


def test_last_axis_split_keeps_the_global_kernel(ext_calls):
    _, rep = _random_dirichlet(PORT, (1, 1, 2), (16, 16, 16), 1,
                               {"method": "cg", "tol": 1e-8, "max_it": 300})
    assert rep["converge"] and ext_calls == []


def test_decomposed_fastdiag_same_passes_as_single():
    out, rep = sharded_fastdiag(PORT, (4, 2, 1))
    ref, rref = sharded_fastdiag(PORT, None)
    assert rep["itr"] == rref["itr"]
    np.testing.assert_allclose(out, ref, atol=1e-12, rtol=1e-12)


def test_mg_spec_key_holds_the_decomposition():
    """The MG cache key tells decomposed and undecomposed hierarchies (and
    two layouts) apart, as the JAX package's ``MGSpec.__hash__`` does."""
    from pyapes_tpu_torch.solver.multigrid import MGSpec

    def spec(decomp):
        return MGSpec((16, 16, 128), (1.0, 1.0, 1.0), device="cpu", decomp=decomp)

    keys = {spec(None).key, spec(DomainDecomposition((4, 2, 1))).key,
            spec(DomainDecomposition((2, 4, 1))).key}
    assert len(keys) == 3
    assert spec(DomainDecomposition((4, 2, 1))).key == spec(DomainDecomposition((4, 2, 1))).key


def test_indivisible_decomposition_raises():
    with pytest.raises(ValueError, match="not divisible"):
        _random_dirichlet(PORT, (3, 1, 1), (16, 16, 16), 0,
                          {"method": "cg", "tol": 1e-8, "max_it": 10})


def _taylor_green(P, models, decomp):
    """``test_sharding.py::test_sharded_periodic_flow_taylor_green``'s run:
    33^2 (32^2 on the torus, (2, 4)-divisible), tol 1e-10, 5 steps of
    2e-3; ``(u, v, p, itr per solve)``."""
    mesh = P.Mesh(P.Box[U2], [33, 33])
    cfg = {"tol": 1e-10}
    if decomp is not None:
        cfg["decomp"] = P.DD(decomp)
    model = models.PeriodicFlow(mesh, nu=0.01, config=cfg)
    X, Y = np.meshgrid(np.linspace(0, 1, 33), np.linspace(0, 1, 33), indexing="ij")
    k = 2 * pi
    model.set_velocity(P.arr(-np.cos(k * X) * np.sin(k * Y)), P.arr(np.sin(k * X) * np.cos(k * Y)))
    itr = []
    for solver in (model.mom_solver, model.p_solver):
        real = solver.solve

        def solve(real=real):
            rep = real()
            itr.append(rep["itr"])
            return rep

        solver.solve = solve
    model.run(2e-3, 5)
    return [P.out(f()[0]) for f in (model.u, model.v, model.p)] + [itr]


def test_decomposed_periodic_flow_taylor_green():
    """The decomposed torus (momentum and singular pressure fastdiag, the
    torus reduction, the projection) reproduces the single-block run to
    the JAX test's 1e-9 with the same passes, and the JAX package's
    single-device run within 1e-8 with the same passes."""
    import pyapes_tpu.models as jmodels
    import pyapes_tpu_torch.models as pmodels

    shd = _taylor_green(PORT, pmodels, (2, 4))
    ref = _taylor_green(PORT, pmodels, None)
    jref = _taylor_green(JAX, jmodels, None)
    assert shd[3] == ref[3] == jref[3] and len(ref[3]) == 15
    for a, b, c, name in zip(shd[:3], ref[:3], jref[:3], ("u", "v", "p")):
        np.testing.assert_allclose(a, b, atol=1e-9, rtol=1e-9, err_msg=name)
        np.testing.assert_allclose(b, c, atol=1e-8, rtol=0, err_msg=name)
