"""The MG-PCG slice against the JAX package (CPU): Mesh -> Field -> FDM
laplacian -> Solver with ``method: "cg"``/``"bicgstab"`` and ``precond:
"mg"``, the same numpy inputs on both sides.

Tolerances: in float64 both packages run the same arithmetic in another
summation order, so the iteration counts are equal and the solutions
agree to 1e-10 relative. In a bf16 V-cycle the two frameworks round at
other places inside the cycle (the preconditioner differs by bf16
round-off), so the counts may differ by one and each solution is held to
the scale the tolerance allows.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.models.poisson import PoissonSolver as JPoissonSolver  # noqa: E402
from pyapes_tpu.solver.fdm import FDM as JFDM  # noqa: E402
from pyapes_tpu.solver.ops import Solver as JSolver  # noqa: E402
from pyapes_tpu.testing import poisson as jpoisson  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil_dot  # noqa: E402
from pyapes_tpu_torch.ops.jacobi import jacobi3d_dot, jacobi3d_x2  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = ["xl", "xu", "yl", "yu", "zl", "zu"]
# bench.py's cg problem (PYAPES_BENCH_METHOD=cg), at a test size
BENCH_MG = {"dtype": "bfloat16", "n_pre": 2, "n_post": 2, "omega": 0.857, "fmg": True,
            "fuse_rz": True}


def _bcs(kinds, vals=None):
    vals = vals or [0.0] * len(kinds)
    return [{"bc_face": f, "bc_type": k, "bc_val": v, "bc_val_opt": None}
            for f, k, v in zip(FACES, kinds, vals)]


def _solve_both(box, nx, kinds, rhs, cfg, jax_cfg=None, vals=None):
    jm = JMesh(JBox[box], None, nx, dtype="double")
    pm = Mesh(Box[box], None, nx, dtype="double")
    jf = JField("p", 1, jm, {"domain": _bcs(kinds, vals), "obstacle": None}, init_val=0.0)
    pf = Field("p", 1, pm, {"domain": _bcs(kinds, vals), "obstacle": None}, init_val=0.0)
    js = JSolver({"fdm": {**cfg, **(jax_cfg or {})}})
    ps = Solver({"fdm": dict(cfg)})
    js.set_eq(JFDM().laplacian(1.0, jf) == jnp.asarray(rhs))
    ps.set_eq(FDM().laplacian(1.0, pf) == torch.from_numpy(rhs))
    return js.solve(), np.asarray(jf()), ps.solve(), pf().numpy()


def _assert_parity(jrep, jx, prep, px, tol, rel=1e-10, itr_slack=0):
    assert abs(prep["itr"] - jrep["itr"]) <= itr_slack, (prep, jrep)
    assert prep["converge"] and jrep["converge"], (prep, jrep)
    assert prep["tol"] <= tol and jrep["tol"] <= tol, (prep, jrep)
    err = np.abs(px - jx).max() / np.abs(jx).max()
    assert err <= rel, err


CG = {"method": "cg", "tol": 1e-10, "max_it": 300, "criterion": "residual"}
MG = {**CG, "precond": "mg"}
BOX3 = (slice(0, 1),) * 3


def test_mgpcg_bench_config_f64_cycle_vs_pallas():
    """The slice's path (FMG + fused r.z + stencil alpha-dot) with the
    cycle in f64: JAX runs its Pallas kernels in interpret mode."""
    nx = [16, 16, 128]
    rhs = np.random.default_rng(0).standard_normal((1, *nx))
    mg = {k: v for k, v in BENCH_MG.items() if k != "dtype"}
    before = (axis_stencil_dot.launches, jacobi3d_x2.launches)
    out = _solve_both(BOX3, nx, ["dirichlet"] * 6, rhs, {**MG, "mg_opts": mg, "donate": True},
                      {"kernel": "pallas"})
    _assert_parity(*out, tol=1e-10)
    assert (axis_stencil_dot.launches, jacobi3d_x2.launches) == before  # CPU: plain versions


def test_mgpcg_bench_config_bf16_cycle_vs_pallas():
    nx = [16, 16, 128]
    rhs = np.random.default_rng(1).standard_normal((1, *nx))
    out = _solve_both(BOX3, nx, ["dirichlet"] * 6, rhs,
                      {**MG, "tol": 1e-6, "mg_opts": BENCH_MG}, {"kernel": "pallas"})
    # bf16 round-off inside the cycle: both meet 1e-6, so the solutions
    # differ by at most ~ the tolerance times the conditioning (1e-4 here)
    _assert_parity(*out, tol=1e-6, rel=1e-4, itr_slack=1)


@pytest.mark.parametrize(
    "case",
    ["plain_cg", "v11_fuse_rz_odd", "mixed_2d", "mixed_3d_symmetrized", "neumann_mean",
     "bicgstab_mg", "bicgstab_mg_3d", "delta_matrix_rbgs", "chebyshev_fmg"],
)
def test_slice_vs_jax(case):
    rng = np.random.default_rng(2)
    box, nx, kinds, cfg, vals = BOX3, [9, 12, 11], ["dirichlet"] * 6, dict(MG), None
    if case == "plain_cg":
        cfg = dict(CG)
    elif case == "v11_fuse_rz_odd":
        cfg["mg_opts"] = {"n_pre": 1, "n_post": 1, "fuse_rz": True}
    elif case == "mixed_2d":
        box, nx = (slice(0, 1), slice(0, 2)), [17, 21]
        kinds, vals = ["neumann", "dirichlet", "neumann", "dirichlet"], [0.0, 1.0, 0.5, 0.0]
    elif case == "mixed_3d_symmetrized":
        kinds = ["dirichlet", "neumann", "symmetry", "dirichlet", "neumann", "dirichlet"]
        cfg["mg_opts"] = {"transfers": "matrix"}
    elif case == "neumann_mean":
        nx, kinds = [9, 9, 9], ["neumann"] * 6
        cfg["nullspace"] = "mean"
    elif case == "bicgstab_mg":
        box, nx = (slice(0, 1), slice(0, 2)), [17, 21]
        kinds = ["neumann", "dirichlet", "dirichlet", "dirichlet"]
        cfg.update({"method": "bicgstab", "mg_opts": {"fmg": True}})
    elif case == "bicgstab_mg_3d":
        cfg["method"] = "bicgstab"
    elif case == "delta_matrix_rbgs":
        cfg.update({"criterion": "delta", "mg_opts": {"smoother": "rbgs", "transfers": "matrix"}})
    else:
        cfg["mg_opts"] = {"smoother": "chebyshev", "fmg": True}
    rhs = rng.standard_normal((1, *nx))
    _assert_parity(*_solve_both(box, nx, kinds, rhs, cfg, vals=vals), tol=cfg["tol"])


def test_runner_poisson_mg():
    """``runner poisson --mg`` runs MG-PCG (not fastdiag) and matches the
    JAX model asked for the same method."""
    out = subprocess.run(
        [sys.executable, "-m", "pyapes_tpu_torch.runner", "poisson",
         "--dim", "3", "--n", "17", "--mg", "--dtype", "double"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout.strip().splitlines()[-1])["report"]
    assert rep["converge"] is True and rep["itr"] > 1
    jm = JMesh(JBox[0:1, 0:1, 0:1], None, [17] * 3, dtype="double")
    jps = JPoissonSolver(jm, jpoisson.poisson_bcs(3), config={
        "method": "cg", "precond": "mg", "tol": 1e-6, "max_it": 2000, "fd_fallback": None})
    jps.solve(jpoisson.poisson_rhs_nd(jm, jps.var))
    assert rep["itr"] == jps.report["itr"]
    assert abs(rep["tol"] - jps.report["tol"]) <= 1e-9 * jps.report["tol"]


def test_cg_fused_paths_equal_unfused():
    """The fused dots (stencil alpha-dot, jacobi r.z) are the plain dots in
    another order: the same iterations and solution as the unfused run."""
    nx = [9, 10, 11]
    rhs = torch.from_numpy(np.random.default_rng(3).standard_normal((1, *nx)))
    sols = []
    for fuse in (False, True):
        pm = Mesh(Box[BOX3], None, nx, dtype="double")
        pf = Field("p", 1, pm, {"domain": _bcs(["dirichlet"] * 6)}, init_val=0.0)
        s = Solver({"fdm": {**MG, "mg_opts": {"n_post": 1, "fuse_rz": fuse}}})
        s.set_eq(FDM().laplacian(1.0, pf) == rhs)
        before = jacobi3d_dot.launches
        rep = s.solve()
        assert jacobi3d_dot.launches == before
        sols.append((rep["itr"], pf().numpy()))
    assert sols[0][0] == sols[1][0]
    assert np.abs(sols[0][1] - sols[1][1]).max() <= 1e-12 * np.abs(sols[0][1]).max()
