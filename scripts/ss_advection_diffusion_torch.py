#!/usr/bin/env python3
"""Steady 1-D advection-diffusion boundary layer against its exact
solution through the PyTorch port (the port of
``demos/ss_advection_diffusion.py``).

    python scripts/ss_advection_diffusion_torch.py [--device cuda] [--json] [--plot]

The demo's set-up: dx 0.01 on [0, 1], velocity 1, epsilon 0.1, central
differences (``limiter: "none"``), homogeneous Dirichlet ends, source 1,
``AdvectionDiffusion.solve_steady``; the gate is the JAX test's
(``test_advection_diffusion_1d``): ``|x - exact| <= 0.01 + 0.1 |exact|``.
On the card, its name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys
from math import exp

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="steady 1-D advection-diffusion (port of "
                                             "demos/ss_advection_diffusion.py)")
    ap.add_argument("--dx", type=float, default=0.01)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="double", choices=("single", "double"))
    ap.add_argument("--json", action="store_true", help="print one JSON line at the end")
    ap.add_argument("--plot", action="store_true", help="write adv_diff.png")
    args = ap.parse_args(argv)

    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import AdvectionDiffusion
    from pyapes_tpu_torch.testing.demo import card, finish, pyplot
    from pyapes_tpu_torch.utils.profile import SolveTimer
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    gpu = card(args.device)
    mesh = Mesh(Box[0:1], None, [args.dx], device=args.device, dtype=args.dtype)
    eps = args.eps
    model = AdvectionDiffusion(mesh, homogeneous_bcs(1, 0.0, "dirichlet"), velocity=1.0,
                               epsilon=eps, limiter="none", init_val=0.5)
    with SolveTimer() as t:
        model.solve_steady(rhs=1.0)
    X = mesh.X
    exact = X - (torch.exp(-(1 - X) / eps) - exp(-1 / eps)) / (1 - exp(-1 / eps))
    sol = model.var()[0]
    err = (sol - exact).abs().max().item()
    within = bool(((sol - exact).abs() <= 0.01 + 0.1 * exact.abs()).all())
    print(f"itr={model.report['itr']} max_err={err:.2e} (wall {t.elapsed:.3f}s, {mesh.device})")

    if args.plot and (plt := pyplot()) is not None:
        plt.plot(X.cpu().numpy(), sol.cpu().numpy(), label="FDM")
        plt.plot(X.cpu().numpy(), exact.cpu().numpy(), "--", label="exact")
        plt.legend()
        plt.savefig("adv_diff.png", dpi=120)
        print("wrote adv_diff.png")
    out = {"demo": "ss_advection_diffusion", "nodes": mesh.nx[0], "dtype": args.dtype,
           "itr": model.report["itr"], "tol": model.report["tol"], "max_err": err,
           "wall_s": t.elapsed, "card": gpu,
           "gate": {"|x - exact| <= 0.01 + 0.1 |exact|": within}}
    return finish("ss_advection_diffusion", out, args.json)


if __name__ == "__main__":
    main()
