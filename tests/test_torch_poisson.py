"""The whole slice against the JAX package (CPU, float64): Mesh -> Field ->
FDM laplacian -> Solver -> fastdiag refinement, with the same numpy inputs
on both sides. Same ``itr``, both tolerances met, solutions within
1e-10 relative."""
import json
import os
import subprocess
import sys
from math import pi

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
from pyapes_tpu_torch.models import PoissonSolver  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.testing import poisson as ppoisson  # noqa: E402
from pyapes_tpu_torch.utils.carry import field_from_numpy  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = ["xl", "xu", "yl", "yu", "zl", "zu"]


def _solve_both(box, nx, bcs_j, bcs_p, rhs, cfg, jax_cfg=None):
    jm = JMesh(JBox[box], None, nx, dtype="double")
    pm = Mesh(Box[box], None, nx, device="cpu", dtype="double")
    jf = JField("p", 1, jm, {"domain": bcs_j, "obstacle": None}, init_val=0.0)
    pf = Field("p", 1, pm, {"domain": bcs_p, "obstacle": None}, init_val=0.0)
    js = JSolver({"fdm": {**cfg, **(jax_cfg or {})}})
    ps = Solver({"fdm": dict(cfg)})
    js.set_eq(JFDM().laplacian(1.0, jf) == jnp.asarray(rhs))
    ps.set_eq(FDM().laplacian(1.0, pf) == torch.from_numpy(rhs))
    return js.solve(), np.asarray(jf()), ps.solve(), pf().numpy()


def _assert_parity(jrep, jx, prep, px, tol):
    assert prep["itr"] == jrep["itr"], (prep, jrep)
    assert jrep["tol"] <= tol and prep["tol"] <= tol, (prep, jrep)
    assert prep["converge"] and jrep["converge"]
    assert np.abs(px - jx).max() <= 1e-10 * np.abs(jx).max()


CFG = {"method": "fastdiag", "tol": 1e-10, "max_it": 50, "criterion": "residual"}


def test_slice_3d_dirichlet_random_rhs_vs_pallas():
    """The JAX side runs its Pallas stencil in interpret mode."""
    nx = [8, 16, 128]
    rhs = np.random.default_rng(0).standard_normal((1, *nx))
    bcs = [{"bc_face": f, "bc_type": "dirichlet", "bc_val": 0.0} for f in FACES]
    out = _solve_both((slice(0, 1),) * 3, nx, bcs, bcs, rhs, CFG, {"kernel": "pallas"})
    _assert_parity(*out, tol=1e-10)


def _mixed(bc_val_x):
    return [
        {"bc_face": f, "bc_type": "dirichlet" if f[0] == "x" else "neumann",
         "bc_val": bc_val_x if f[0] == "x" else 0.5, "bc_val_opt": None}
        for f in FACES
    ]


@pytest.mark.parametrize("case", ["2d_callable", "3d_mixed", "2d_neumann_mean"])
def test_slice_vs_jax_plain(case):
    rng = np.random.default_rng(1)
    cfg = dict(CFG)
    if case == "2d_callable":
        box, nx = (slice(0, 1), slice(0, 1)), [33, 33]
        bcs_j, bcs_p = jpoisson.poisson_bcs(2), ppoisson.poisson_bcs(2)
    elif case == "3d_mixed":
        box, nx = (slice(0, 1), slice(0, 2), slice(0, 1)), [17, 17, 17]
        bcs_j, bcs_p = _mixed(1.0), _mixed(1.0)
    else:
        box, nx = (slice(0, 1), slice(0, 1)), [17, 21]
        bcs_j = [{"bc_face": f, "bc_type": "neumann", "bc_val": 0.0} for f in FACES[:4]]
        bcs_p = [dict(b) for b in bcs_j]
        cfg["nullspace"] = "mean"
    rhs = rng.standard_normal((1, *nx))
    _assert_parity(*_solve_both(box, nx, bcs_j, bcs_p, rhs, cfg), tol=1e-10)


def test_poisson_solver_parity_and_order():
    """The model template: the port resolves its default config to the
    fastdiag solve (the JAX model is asked for fastdiag explicitly — its
    probe falls back to MG-PCG, see ROADMAP), and the error against the
    exact solution is the predicted discretization error (pi h)^2 / 12."""
    n = 17
    jm = JMesh(JBox[0:1, 0:1, 0:1], None, [n] * 3, dtype="double")
    pm = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device="cpu", dtype="double")
    jps = JPoissonSolver(jm, jpoisson.poisson_bcs(3), config={"fd_fallback": None})
    pps = PoissonSolver(pm, ppoisson.poisson_bcs(3))
    jx = np.asarray(jps.solve(jpoisson.poisson_rhs_nd(jm, jps.var))()[0])
    px = pps.solve(ppoisson.poisson_rhs_nd(pm, pps.var))()[0].numpy()
    assert pps.report["itr"] == jps.report["itr"] == 1
    assert pps.report["converge"]
    assert np.abs(px - jx).max() <= 1e-10 * np.abs(jx).max()
    exact = ppoisson.poisson_exact_nd(pm).numpy()
    rel = np.abs(px - exact).max() / np.abs(exact).max()
    h = 1.0 / (n - 1)
    lam_h = 3 * (4 / h**2) * np.sin(pi * h / 2) ** 2
    predicted = 3 * pi**2 / lam_h - 1.0  # ~ (pi h)^2 / 12
    assert abs(rel / predicted - 1.0) < 0.05, (rel, predicted)


def test_field_carry_and_non_mutating_arithmetic():
    pm = Mesh(Box[0:1, 0:1], None, [5, 6], device="cpu", dtype="double")
    f = Field("u", 2, pm, None)
    vals = np.random.default_rng(3).standard_normal((2, 5, 6))
    field_from_numpy(f, vals, varo=2 * vals)
    before = f().clone()
    g = f + 1.0
    h = f * 2.0
    f.set_var_tensor(torch.zeros(5, 6, dtype=torch.float64), insert=1)
    assert torch.equal(g(), before + 1.0) and torch.equal(h(), 2 * before)
    assert torch.equal(f.VARo, torch.from_numpy(2 * vals))
    assert torch.equal(f()[0], before[0]) and not f()[1].any()


def test_runner_poisson_3d():
    out = subprocess.run(
        [sys.executable, "-m", "pyapes_tpu_torch.runner", "poisson",
         "--dim", "3", "--n", "17", "--dtype", "double", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["report"]["converge"] is True
    assert rec["n"] == 17 and rec["wall_s"] > 0
