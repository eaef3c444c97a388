#!/usr/bin/env python3
"""Axisymmetric (r-z) Poisson with callable Dirichlet BCs and a Neumann
axis condition through the PyTorch port (the port of
``demos/poisson_axisymmetric.py``); exact solution ``exp(-z) cos(r)``.

    python scripts/poisson_axisymmetric_torch.py [--device cuda] [--json] [--plot]

The demo's set-up: 101^2 nodes on the unit cylinder, BiCGSTAB at tol
1e-5; the gate is the JAX rz Poisson test's, ``|x - exact| <= 1e-3 +
1e-3 |exact|``. On the card, its name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys
from math import cos, exp

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="rz Poisson (port of "
                                             "demos/poisson_axisymmetric.py)")
    ap.add_argument("--n", type=int, default=101)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="double", choices=("single", "double"))
    ap.add_argument("--json", action="store_true", help="print one JSON line at the end")
    ap.add_argument("--plot", action="store_true", help="write poisson_rz.png")
    args = ap.parse_args(argv)

    import torch

    from pyapes_tpu_torch.geometry import Cylinder
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.testing.demo import card, finish, pyplot
    from pyapes_tpu_torch.utils.profile import SolveTimer
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import CylinderBoundary

    gpu = card(args.device)
    mesh = Mesh(Cylinder[0:1, 0:1], None, [args.n, args.n], device=args.device,
                dtype=args.dtype)
    f_bc = CylinderBoundary(
        rl={"bc_type": "neumann", "bc_val": 0.0},
        ru={"bc_type": "dirichlet", "bc_val": lambda grid, m, v, o: torch.exp(-grid[1]) * cos(1)},
        zl={"bc_type": "dirichlet", "bc_val": lambda grid, m, v, o: torch.cos(grid[0])},
        zu={"bc_type": "dirichlet",
            "bc_val": lambda grid, m, v, o: torch.cos(grid[0]) * exp(-1)},
    )
    var = Field("U", 1, mesh, {"domain": f_bc(), "obstacle": None}, init_val=0.0)
    rhs_val = -torch.sin(mesh.X) / (mesh.X * torch.exp(mesh.Z))
    rhs_val = torch.where(mesh.X == 0.0, -1.0 / torch.exp(mesh.Z), rhs_val)
    rhs = torch.zeros_like(var())
    rhs[0] = rhs_val

    solver = Solver({"fdm": {"method": "bicgstab", "tol": 1e-5, "max_it": 1000,
                             "report": True}})
    solver.set_eq(FDM().laplacian(1.0, var) == rhs)
    with SolveTimer() as t:
        rep = solver.solve()
    exact = torch.exp(-mesh.Z) * torch.cos(mesh.X)
    sol = var()[0]
    err = (sol - exact).abs().max().item()
    within = bool(((sol - exact).abs() <= 1e-3 + 1e-3 * exact.abs()).all())
    print(f"itr={rep['itr']} max_err={err:.2e} (wall {t.elapsed:.3f}s, {mesh.device})")

    if args.plot and (plt := pyplot()) is not None:
        plt.contourf(mesh.R.cpu().numpy(), mesh.Z.cpu().numpy(), sol.cpu().numpy(), levels=30)
        plt.xlabel("r")
        plt.ylabel("z")
        plt.savefig("poisson_rz.png", dpi=120)
        print("wrote poisson_rz.png")
    out = {"demo": "poisson_axisymmetric", "n": args.n, "dtype": args.dtype, "itr": rep["itr"],
           "tol": rep["tol"], "max_err": err, "wall_s": t.elapsed, "card": gpu,
           "gate": {"|x - exact| <= 1e-3 + 1e-3 |exact|": within}}
    return finish("poisson_axisymmetric", out, args.json)


if __name__ == "__main__":
    main()
