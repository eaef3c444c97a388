#!/usr/bin/env python3
"""2-D Poisson with Dirichlet BCs against the manufactured solution through
the PyTorch port (the port of ``demos/poisson_pure_dirichlet.py``).

    python scripts/poisson_pure_dirichlet_torch.py [--device cuda] [--json] [--plot]

The demo's set-up: 129^2 nodes, ``PoissonSolver`` with ``precond: "mg"``
(the model's fastdiag, MG-PCG as its fallback; ``--method cg``: MG-PCG,
where the JAX package's model lands, its separability probe rejecting
every domain BC), the manufactured
``poisson_rhs_nd`` / ``poisson_exact_nd`` pair; the gates are the JAX
Poisson MMS test's: converged, and ``|x - exact| <= 0.01 + 0.1 |exact|``.
On the card, its name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="2-D Dirichlet Poisson (port of "
                                             "demos/poisson_pure_dirichlet.py)")
    ap.add_argument("--n", type=int, default=129)
    ap.add_argument("--method", choices=("model", "cg"), default="model",
                    help="the model's choice (fastdiag) or MG-PCG (the JAX package's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="double", choices=("single", "double"))
    ap.add_argument("--json", action="store_true", help="print one JSON line at the end")
    ap.add_argument("--plot", action="store_true", help="write poisson_dirichlet.png")
    args = ap.parse_args(argv)

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import PoissonSolver
    from pyapes_tpu_torch.testing.demo import card, finish, pyplot
    from pyapes_tpu_torch.testing.poisson import poisson_bcs, poisson_exact_nd, poisson_rhs_nd
    from pyapes_tpu_torch.utils.profile import SolveTimer

    gpu = card(args.device)
    mesh = Mesh(Box[0:1, 0:1], None, [args.n, args.n], device=args.device, dtype=args.dtype)
    config = {"precond": "mg"} if args.method == "model" else {"precond": "mg", "method": "cg"}
    model = PoissonSolver(mesh, poisson_bcs(2), config=config)
    rhs = poisson_rhs_nd(mesh, model.var)
    with SolveTimer() as t:
        var = model.solve(rhs)
    sol, exact = var()[0], poisson_exact_nd(mesh)
    err = (sol - exact).abs().max().item()
    within = bool(((sol - exact).abs() <= 0.01 + 0.1 * exact.abs()).all())
    rep = model.report
    print(f"converged={rep['converge']} itr={rep['itr']} max_err={err:.2e} "
          f"(wall {t.elapsed:.3f}s, {mesh.device})")

    if args.plot and (plt := pyplot()) is not None:
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        X, Y = mesh.X.cpu().numpy(), mesh.Y.cpu().numpy()
        axes[0].contourf(X, Y, sol.cpu().numpy(), levels=30)
        axes[0].set_title("FDM")
        axes[1].contourf(X, Y, exact.cpu().numpy(), levels=30)
        axes[1].set_title("Exact")
        plt.savefig("poisson_dirichlet.png", dpi=120)
        print("wrote poisson_dirichlet.png")
    out = {"demo": "poisson_pure_dirichlet", "n": args.n, "dtype": args.dtype,
           "method": model.solver.config["fdm"]["method"],
           "itr": rep["itr"], "tol": rep["tol"], "max_err": err, "wall_s": t.elapsed,
           "card": gpu,
           "gate": {"converge": bool(rep["converge"]),
                    "|x - exact| <= 0.01 + 0.1 |exact|": within}}
    return finish("poisson_pure_dirichlet", out, args.json)


if __name__ == "__main__":
    main()
