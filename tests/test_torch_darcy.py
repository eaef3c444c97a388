"""The variable-Γ (Darcy) slice against the JAX package (CPU, float64):
the Γ-aware multigrid hierarchy, whole solves through ``fdm.laplacian(Γ,
var) == rhs`` -> ``Solver.solve``, and the runner's ``darcy`` case.

Tolerances: in float64 both packages run the same arithmetic in another
summation order, so the hierarchy's Γ levels, diagonals and one V-cycle
agree to 1e-12 relative, whole solves take the same iterations and agree
to 1e-10 relative (both within ``tol`` of the system), and the runner's
fluxes to 1e-9.
"""
import argparse
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu import runner as jrunner  # noqa: E402
from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.solver import multigrid as jmg  # noqa: E402
from pyapes_tpu.solver.fdm import FDM as JFDM  # noqa: E402
from pyapes_tpu.solver.ops import Solver as JSolver  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.ops import jacobi as jacobi_mod  # noqa: E402
from pyapes_tpu_torch.ops.diff_field import diff_field, diff_jacobi  # noqa: E402
from pyapes_tpu_torch.ops.stencil import apply_diff_field, div_surgery_info  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.solver import multigrid as pmg  # noqa: E402
from pyapes_tpu_torch.solver.linalg import build as build_mod  # noqa: E402
from pyapes_tpu_torch.solver.linalg import dispatch  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = ["xl", "xu", "yl", "yu", "zl", "zu"]
D, N = ("dirichlet", "dirichlet"), ("neumann", "neumann")
ND, DN = ("neumann", "dirichlet"), ("dirichlet", "neumann")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _bcs(kinds):
    return [{"bc_face": f, "bc_type": k, "bc_val": 0.0, "bc_val_opt": None}
            for f, k in zip(FACES, kinds)]


# (shape, face kinds, stacked Γ, face rule)
SPECS = {
    "dirichlet_3d": ((9, 12, 11), (D, D, D), False, "arithmetic"),
    "mixed_2d_harmonic": ((17, 13), (ND, DN), False, "harmonic"),
    "stacked_3d_neumann": ((9, 9, 10), (ND, D, N), True, "arithmetic"),
}


def _spec_pair(case, **opts):
    shape, fk, aniso, avg = SPECS[case]
    lengths = [1.0, 2.0, 0.5][: len(shape)]
    rng = np.random.default_rng(4)
    g = 1.0 + rng.random(((len(shape),) if aniso else ()) + shape)
    j = jmg.MGSpec(shape, lengths, dtype=jnp.float64, face_kinds=fk, var_gamma=True,
                   vg_avg=avg, **opts)
    p = pmg.MGSpec(shape, lengths, dtype=torch.float64, face_kinds=fk, var_gamma=True,
                   vg_avg=avg, device="cpu", **opts)
    j.set_gamma(jnp.asarray(g))
    p.set_gamma(torch.from_numpy(g))
    return j, p, rng.standard_normal((1,) + shape)


@pytest.mark.parametrize("case", sorted(SPECS))
def test_gamma_levels_and_vcycle_match_jax(case):
    j, p, r = _spec_pair(case, omega=0.8, fmg=True)
    assert p.shapes == j.shapes and p._vg_surgery() == j._vg_surgery()
    for shape, jg, pg, jd in zip(j.shapes, j._g_levels, p._g_levels, j._gd_levels):
        pd = p._diag(shape)
        assert tuple(pg.shape) == tuple(jg.shape) and tuple(pd.shape) == tuple(jd.shape)
        assert _rel(pg.numpy(), jg) <= 1e-12
        assert _rel(pd.numpy(), jd) <= 1e-12
    assert _rel(p.preconditioner()(torch.from_numpy(r)).numpy(),
                j.preconditioner()(jnp.asarray(r))) <= 1e-12
    assert _rel(p.fmg(torch.from_numpy(r)).numpy(), j.fmg(jnp.asarray(r))) <= 1e-12


@pytest.mark.parametrize("smoother", ["rbgs", "chebyshev"])
def test_gamma_vcycle_other_smoothers_match_jax(smoother):
    j, p, r = _spec_pair("mixed_2d_harmonic", smoother=smoother, transfers="matrix")
    assert _rel(p.preconditioner()(torch.from_numpy(r)).numpy(),
                j.preconditioner()(jnp.asarray(r))) <= 1e-12


def test_var_gamma_3d_dirichlet_levels_take_no_constant_jacobi(monkeypatch):
    """An all-Dirichlet 3-D variable-Γ hierarchy never reaches the
    constant-coefficient Jacobi kernels (they would give the Γ = 1
    answer without an error): every smooth and residual is a
    ``diff_jacobi`` pass, and the fused r.z is off."""
    j, p, r = _spec_pair("dirichlet_3d", fuse_rz=True, n_pre=2, n_post=2)
    assert not any(p._kernels(s) for s in p.shapes) and not p.can_fuse_rz()

    def constant_kernel(*args, **kwargs):
        raise AssertionError("a constant-coefficient Jacobi kernel ran on a variable-Γ level")

    for name in ("jacobi3d", "jacobi3d_dot", "jacobi3d_x2"):
        monkeypatch.setattr(pmg, name, constant_kernel)
    calls = []
    real = pmg.diff_jacobi
    monkeypatch.setattr(pmg, "diff_jacobi", lambda *a, **k: calls.append(a[-1]) or real(*a, **k))
    z = p.preconditioner()(torch.from_numpy(r))
    assert {"smooth0", "smooth", "resid"} <= set(calls)
    assert all(d is None for d in p._gd_levels)  # the Jacobi pass reads no diagonal field
    assert _rel(z.numpy(), j.preconditioner()(jnp.asarray(r))) <= 1e-12


def _solve_both(nx, kinds, g, rhs, cfg, avg="arithmetic", box=None):
    box = box or tuple(slice(0, 1) for _ in nx)
    jm = JMesh(JBox[box], None, list(nx), dtype="double")
    pm = Mesh(Box[box], None, list(nx), device="cpu", dtype="double")
    jf = JField("p", 1, jm, {"domain": _bcs(kinds), "obstacle": None}, init_val=0.0)
    pf = Field("p", 1, pm, {"domain": _bcs(kinds), "obstacle": None}, init_val=0.0)
    js, ps = JSolver({"fdm": dict(cfg)}), Solver({"fdm": dict(cfg)})
    jg = tuple(jnp.asarray(c) for c in g) if isinstance(g, tuple) else jnp.asarray(g)
    js.set_eq(JFDM().laplacian(jg, jf, avg=avg) == jnp.asarray(rhs))
    ps.set_eq(FDM().laplacian(g, pf, avg=avg) == torch.from_numpy(rhs))
    return js.solve(), np.asarray(jf()), ps.solve(), pf().numpy()


def _assert_parity(jrep, jx, prep, px, tol, rel=1e-10):
    assert prep["itr"] == jrep["itr"], (prep, jrep)
    assert prep["converge"] and jrep["converge"], (prep, jrep)
    assert prep["tol"] <= tol and jrep["tol"] <= tol, (prep, jrep)
    assert _rel(px, jx) <= rel


MG = {"method": "cg", "tol": 1e-10, "max_it": 300, "criterion": "residual", "precond": "mg"}


@pytest.mark.parametrize("case", ["cg_mg_dirichlet_3d", "cg_bench_opts_f64_cycle",
                                  "bicgstab_neumann_harmonic_2d", "cg_anisotropic_2d",
                                  "cg_neumann_3d_unscaled"])
def test_var_gamma_solve_vs_jax(case):
    rng = np.random.default_rng(6)
    nx, kinds, cfg, avg = (9, 12, 11), ["dirichlet"] * 6, dict(MG), "arithmetic"
    if case == "cg_bench_opts_f64_cycle":
        cfg["mg_opts"] = {"n_pre": 2, "n_post": 2, "omega": 0.857, "fmg": True}
    elif case == "bicgstab_neumann_harmonic_2d":
        nx, kinds, avg = (17, 21), ["dirichlet", "dirichlet", "neumann", "neumann"], "harmonic"
        cfg.update({"method": "bicgstab", "mg_opts": {"fmg": True}})
    elif case == "cg_anisotropic_2d":
        nx = (17, 21)
        kinds = ["dirichlet"] * 4
    elif case == "cg_neumann_3d_unscaled":
        kinds = ["neumann", "dirichlet", "dirichlet", "dirichlet", "dirichlet", "neumann"]
    g = 1.0 + rng.random(nx)
    if case == "cg_anisotropic_2d":
        g = (1.0 + rng.random(nx), 2.0 + rng.random(nx))
    rhs = rng.standard_normal((1, *nx))
    _assert_parity(*_solve_both(nx, kinds, g, rhs, cfg, avg), tol=cfg["tol"])


def test_var_gamma_3d_mms_vs_jax():
    """JAX ``test_var_gamma.py::test_var_gamma_3d_mms``: Γ = 1+x+y+z, φ =
    sin(πx)sin(πy)sin(πz), all-Dirichlet, Γ-aware MG-PCG."""
    n = 33
    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device="cpu", dtype="double")
    X, Y, Z = (np.asarray(g) for g in mesh._grid_np)
    g = 1.0 + X + Y + Z
    sx, sy, sz = np.sin(np.pi * X), np.sin(np.pi * Y), np.sin(np.pi * Z)
    cx, cy, cz = np.cos(np.pi * X), np.cos(np.pi * Y), np.cos(np.pi * Z)
    phi = sx * sy * sz
    rhs = (-3.0 * np.pi**2 * g * phi) + np.pi * (cx * sy * sz + sx * cy * sz + sx * sy * cz)
    cfg = {"method": "cg", "tol": 1e-8, "max_it": 100, "criterion": "residual", "precond": "mg"}
    jrep, jx, prep, px = _solve_both((n,) * 3, ["dirichlet"] * 6, g, rhs[None], cfg)
    _assert_parity(jrep, jx, prep, px, tol=1e-8)
    assert prep["itr"] <= 20
    assert np.linalg.norm(px[0] - phi) / np.linalg.norm(phi) < 0.01


def test_new_gamma_on_cached_spec_is_used():
    """Γ levels are per solve call: a second solve with another Γ on the
    same cached spec equals a fresh solve with that Γ (the JAX
    ``test_var_gamma_mg_gamma_streams_no_recompile`` case)."""
    n = 33
    mesh = Mesh(Box[0:1, 0:1], None, [n, n], device="cpu", dtype="double")
    X, Y = (np.asarray(g) for g in mesh._grid_np)
    g1 = 1.0 + X + 2.0 * Y
    g2 = 1.0 + 99.0 * (((X - 0.5) ** 2 + (Y - 0.5) ** 2) < 0.04)
    rhs = torch.ones((1, n, n), dtype=torch.float64)
    cfg = {"fdm": {**MG, "tol": 1e-9, "max_it": 400}}

    def solve(g, s):
        var = Field("t", 1, mesh, {"domain": _bcs(["dirichlet"] * 4)}, init_val=0.0)
        s.set_eq(FDM().laplacian(g, var) == rhs)
        return s.solve(), var()

    dispatch.clear_cache()
    s = Solver(cfg)
    rep1, _ = solve(g1, s)
    spec = next(iter(build_mod._MG_CACHE.values()))
    rep2, x2 = solve(g2, s)
    assert len(build_mod._MG_CACHE) == 1 and next(iter(build_mod._MG_CACHE.values())) is spec
    assert torch.equal(spec._g_levels[0], torch.from_numpy(g2))
    dispatch.clear_cache()
    rep_fresh, x_fresh = solve(g2, Solver(cfg))
    assert rep2 == rep_fresh and torch.equal(x2, x_fresh)
    assert rep1["converge"] and rep2["converge"]
    r = apply_diff_field(x2, torch.from_numpy(g2), tuple(1.0 / float(d) ** 2 for d in mesh.dx_np),
                         div_surgery_info(None, 2))[0, 1:-1, 1:-1] - 1.0
    assert r.abs().max().item() < 1e-6


def test_neumann_cg_var_gamma_gets_no_row_scale(monkeypatch):
    """CG with a Neumann face: a constant-coefficient Laplacian is row-scaled
    by 3/2 on its surgered rows; a variable-Γ one is not (its surgered-row
    asymmetry is Γ-dependent; JAX ``linalg.py:986-995``)."""
    seen = []
    real = dispatch.build_solver

    def spy(*args, **kwargs):
        fn, sym_vecs, rhs_shift = real(*args, **kwargs)
        seen.append(sym_vecs)
        return fn, sym_vecs, rhs_shift

    monkeypatch.setattr(dispatch, "build_solver", spy)
    nx = (9, 10, 11)
    kinds = ["neumann", "dirichlet", "dirichlet", "dirichlet", "dirichlet", "neumann"]
    mesh = Mesh(Box[0:1, 0:1, 0:1], None, list(nx), device="cpu", dtype="double")
    rhs = torch.from_numpy(np.random.default_rng(8).standard_normal((1, *nx)))
    for coeff in (1.0, torch.from_numpy(1.0 + np.random.default_rng(9).random(nx))):
        var = Field("p", 1, mesh, {"domain": _bcs(kinds)}, init_val=0.0)
        s = Solver({"fdm": dict(MG)})
        s.set_eq(FDM().laplacian(coeff, var) == rhs)
        assert s.solve()["converge"]
    assert seen[0] is not None and seen[1] is None


def test_diff_field_term_dispatch():
    """The descriptor carries ``(surgery, (inv_dx2, avg))``, the params Γ
    on the solve's device and dtype; the term is not fastdiag-separable, so
    it gets no fused α-dot and ``fd_fallback`` resolves to the Krylov
    method."""
    nx = (9, 10)
    mesh = Mesh(Box[0:1, 0:2], None, list(nx), device="cpu", dtype="single")
    var = Field("p", 1, mesh, {"domain": _bcs(["neumann", "dirichlet", "dirichlet",
                                               "symmetry"])}, init_val=0.0)
    g = 1.0 + np.random.default_rng(2).random(nx)
    op = FDM().laplacian(g, var, avg="harmonic")
    desc = dispatch._term_descriptor(op.ops[0])
    inv = (1.0 / (1.0 / 8) ** 2, 1.0 / (2.0 / 9) ** 2)
    assert desc[0] == "diff_field" and desc[4] == (("neumann", "none"), ("none", "neumann"))
    assert desc[5][1] == "harmonic" and np.allclose(desc[5][0], inv, rtol=1e-6)
    tp = dispatch._term_params(op.ops[0], desc, var())
    assert tp["gamma"].dtype == torch.float32 and tp["gamma"].is_contiguous()
    assert not build_mod.fd_separable((desc,), (tp,))
    assert build_mod._make_Aop_dot((desc,), (tp,), 2) is None
    s = Solver({"fdm": {"method": "fastdiag", "fd_fallback": "bicgstab", "precond": "mg",
                        "tol": 1e-6, "max_it": 100, "criterion": "residual"}})
    s.set_eq(FDM().laplacian(g, var) == torch.ones((1, *nx)))
    rep = s.solve()
    assert rep["converge"] and rep["itr"] > 1


def test_var_gamma_solve_on_cpu_counts_no_launch():
    nx = (9, 10, 11)
    mesh = Mesh(Box[0:1, 0:1, 0:1], None, list(nx), device="cpu", dtype="double")
    var = Field("p", 1, mesh, {"domain": _bcs(["dirichlet"] * 6)}, init_val=0.0)
    s = Solver({"fdm": {**MG, "mg_opts": {"fmg": True, "fuse_rz": True}}})
    s.set_eq(FDM().laplacian(np.full(nx, 2.0), var) == torch.ones((1, *nx), dtype=torch.float64))
    fns = (diff_field, diff_jacobi, jacobi_mod.jacobi3d, jacobi_mod.jacobi3d_x2)
    before = [f.launches for f in fns]
    assert s.solve()["converge"]
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("avg", ["arithmetic", "harmonic"])
def test_runner_darcy_vs_jax(avg):
    """``runner darcy`` (the CLI, f64) against the JAX runner's JSON
    numbers on the same 2-D case."""
    out = subprocess.run(
        [sys.executable, "-m", "pyapes_tpu_torch.runner", "darcy", "--n", "33", "--dtype",
         "double", "--avg", avg, "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    ref = jrunner._run_darcy(argparse.Namespace(
        n=33, dtype="double", tol=1e-6, max_it=2000, seed=7, contrast=-2.5, avg=avg,
        vtk=None, save=None, resume=None))
    assert got["report"]["converge"] and got["report"]["itr"] == ref["report"]["itr"]
    for key in ("flux_in", "flux_out", "k_eff", "k_harmonic", "k_arithmetic"):
        assert abs(got[key] - ref[key]) <= 1e-9 * abs(ref[key]), key
    assert ref["k_harmonic"] <= got["k_eff"] <= ref["k_arithmetic"]
