"""The ten demo ports (``scripts/<demo>_torch.py``) on the CPU at a small
size, each under its JAX demo's own gates (the scripts raise
``SystemExit`` on a missed gate). Where the JAX demo is cheap at that size
its numbers are recomputed here with the JAX package, as the demo computes
them, and the port's must equal them: float64, the same algorithm with the
sums in another order, so 1e-10 relative on the errors against the exact
solutions and the same iteration counts (the rz BiCGSTAB case: within 2
iterations and 1%, its docstring says why).
"""
import importlib.util
import os
from math import exp, pi

import jax.numpy as jnp
import numpy as np
import pytest
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

torch = pytest.importorskip("torch")


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    path = os.path.join(REPO, "scripts", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, *args):
    out = _script(name).main(["--device", "cpu", *args])
    assert out["ok"] and all(out["gate"].values()) and out["card"] is None
    return out


def _jax_burgers(n, steps, dt):
    from pyapes_tpu.geometry import Box
    from pyapes_tpu.mesh import Mesh
    from pyapes_tpu.models import Burgers1D
    from pyapes_tpu.testing.burgers import burger_exact_nd

    mesh = Mesh(Box[0:2 * pi], None, [n])
    model = Burgers1D(mesh, nu=0.1)
    for _ in range(steps):
        model.step(dt)
    ex = np.asarray(burger_exact_nd(mesh, 0.1, model.var.t))
    return np.linalg.norm(np.asarray(model.var()[0]) - ex) / np.linalg.norm(ex)


def _jax_poisson_dirichlet(n):
    from pyapes_tpu.geometry import Box
    from pyapes_tpu.mesh import Mesh
    from pyapes_tpu.models import PoissonSolver
    from pyapes_tpu.testing.poisson import poisson_bcs, poisson_exact_nd, poisson_rhs_nd

    mesh = Mesh(Box[0:1, 0:1], None, [n, n])
    model = PoissonSolver(mesh, poisson_bcs(2), config={"precond": "mg"})
    var = model.solve(poisson_rhs_nd(mesh, model.var))
    err = np.abs(np.asarray(var()[0]) - np.asarray(poisson_exact_nd(mesh))).max()
    return err, model.report


def _jax_ss_advection_diffusion(dx, eps):
    from pyapes_tpu.geometry import Box
    from pyapes_tpu.mesh import Mesh
    from pyapes_tpu.models import AdvectionDiffusion
    from pyapes_tpu.variables.bcs import homogeneous_bcs

    mesh = Mesh(Box[0:1], None, [dx])
    model = AdvectionDiffusion(mesh, homogeneous_bcs(1, 0.0, "dirichlet"), velocity=1.0,
                               epsilon=eps, limiter="none", init_val=0.5)
    model.solve_steady(rhs=1.0)
    X = mesh.X
    exact = X - (jnp.exp(-(1 - X) / eps) - exp(-1 / eps)) / (1 - exp(-1 / eps))
    return np.abs(np.asarray(model.var()[0]) - np.asarray(exact)).max(), model.report


def _jax_poisson_axisymmetric(n):
    from math import cos

    from pyapes_tpu.geometry import Cylinder
    from pyapes_tpu.mesh import Mesh
    from pyapes_tpu.solver import FDM, Solver
    from pyapes_tpu.variables import Field
    from pyapes_tpu.variables.bcs import CylinderBoundary

    mesh = Mesh(Cylinder[0:1, 0:1], None, [n, n])
    f_bc = CylinderBoundary(
        rl={"bc_type": "neumann", "bc_val": 0.0},
        ru={"bc_type": "dirichlet", "bc_val": lambda grid, m, v, o: jnp.exp(-grid[1]) * cos(1)},
        zl={"bc_type": "dirichlet", "bc_val": lambda grid, m, v, o: jnp.cos(grid[0])},
        zu={"bc_type": "dirichlet", "bc_val": lambda grid, m, v, o: jnp.cos(grid[0]) * exp(-1)},
    )
    var = Field("U", 1, mesh, {"domain": f_bc(), "obstacle": None}, init_val=0.0)
    rhs_val = -jnp.sin(mesh.X) / (mesh.X * jnp.exp(mesh.Z))
    rhs_val = jnp.where(mesh.X == 0.0, -1.0 / jnp.exp(mesh.Z), rhs_val)
    rhs = jnp.zeros_like(var()).at[0].set(rhs_val)
    solver = Solver({"fdm": {"method": "bicgstab", "tol": 1e-5, "max_it": 1000,
                             "report": False}})
    solver.set_eq(FDM().laplacian(1.0, var) == rhs)
    rep = solver.solve()
    exact = np.asarray(jnp.exp(-mesh.Z) * jnp.cos(mesh.X))
    return np.abs(np.asarray(var()[0]) - exact).max(), rep


def test_burgers_1d_matches_jax_demo():
    """201 -> 101 nodes, 10 steps of 1e-2 (the JAX model test's set-up)."""
    out = _run("burgers_1d", "--n", "101", "--steps", "10", "--dt", "0.01")
    assert out["rel_l2"] == pytest.approx(_jax_burgers(101, 10, 0.01), rel=1e-10)


def test_poisson_pure_dirichlet_matches_jax_demo():
    """The JAX demo's model lands on MG-PCG (its separability probe rejects
    every domain BC), the port's on fastdiag: ``--method cg`` takes the JAX
    package's and equals it; the model's choice meets the gates too."""
    out = _run("poisson_pure_dirichlet", "--n", "33", "--method", "cg")
    err, rep = _jax_poisson_dirichlet(33)
    assert out["itr"] == rep["itr"] and out["method"] == "cg"
    assert out["max_err"] == pytest.approx(err, rel=1e-10)
    assert _run("poisson_pure_dirichlet", "--n", "33")["method"] == "fastdiag"


def test_ss_advection_diffusion_matches_jax_demo():
    """The demo's own size (dx 0.01: 101 nodes)."""
    out = _run("ss_advection_diffusion")
    err, rep = _jax_ss_advection_diffusion(0.01, 0.1)
    assert out["itr"] == rep["itr"]
    assert out["max_err"] == pytest.approx(err, rel=1e-10)


def test_poisson_axisymmetric_matches_jax_demo():
    """BiCGSTAB on the nonsymmetric rz system with the demo's ``delta``
    stop at 1e-5: round-off moves the stop to a neighbouring iterate (96
    against JAX's 95 here), so the count is held to within 2 and the error
    against the exact solution to 1% of JAX's (both ~2e-5, the gate 1e-3)."""
    out = _run("poisson_axisymmetric", "--n", "33")
    err, rep = _jax_poisson_axisymmetric(33)
    assert abs(out["itr"] - rep["itr"]) <= 2
    assert out["max_err"] == pytest.approx(err, rel=1e-2)


@pytest.mark.parametrize("name, args", [
    ("darcy_heterogeneous", ["--n", "33"]),
    ("lid_driven_cavity", ["--n", "33", "--steps", "150", "--dt", "0.02"]),
    ("natural_convection", ["--n", "33", "--steps", "60", "--dt", "0.0125"]),
    ("moving_obstacle_channel", ["--n", "17", "--steps", "20", "--every", "10"]),
    ("rfp_selfconsistent", ["--nr", "40", "--nz", "80", "--chunks", "2", "--chunk", "150",
                            "--dt", "4e-4", "--refresh", "50"]),
    ("sharded_poisson", ["--n", "16"]),
])
def test_demo_port_meets_its_gates(name, args, capsys):
    """The other six at a small size (the cavity, convection and RFP cases
    at the JAX tests' set-ups, whose gates the scripts keep), ``--json``
    printing one parseable line."""
    import json

    out = _run(name, *args, "--json")
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1]
    assert json.loads(line)["ok"] is True and out["demo"] == name
