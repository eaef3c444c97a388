#!/usr/bin/env python3
"""Darcy flow through a heterogeneous porous medium through the PyTorch
port (the port of ``demos/darcy_heterogeneous.py``): ``div(K grad p) = 0``
with the variable-coefficient Laplacian (the hand-written variable-Γ
kernels on the card), a log-normal K with low-K inclusions, p = 1 at the
inlet, 0 at the outlet, no-flux walls.

    python scripts/darcy_heterogeneous_torch.py [--n 129] [--device cuda] [--json] [--plot]

The demo's set-up and gates: BiCGSTAB with the Γ-aware multigrid at tol
1e-10 (residual criterion); converged, inlet/outlet flux imbalance below
2%, and K_eff between the harmonic and arithmetic means (Wiener bounds).
On the card, its name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="heterogeneous Darcy (port of "
                                             "demos/darcy_heterogeneous.py)")
    ap.add_argument("--n", type=int, default=129)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="double", choices=("single", "double"))
    ap.add_argument("--json", action="store_true", help="print one JSON line at the end")
    ap.add_argument("--plot", action="store_true", help="write darcy.png")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.testing.darcy import inlet_outlet_flux, log_normal_permeability
    from pyapes_tpu_torch.testing.demo import card, finish, pyplot
    from pyapes_tpu_torch.utils.profile import SolveTimer
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import mixed_bcs

    gpu = card(args.device)
    n = args.n
    mesh = Mesh(Box[0:1, 0:1], None, [n, n], device=args.device, dtype=args.dtype)
    K = log_normal_permeability(mesh)
    bcs = mixed_bcs([1.0, 0.0, 0.0, 0.0], ["dirichlet", "dirichlet", "neumann", "neumann"])
    p = Field("p", 1, mesh, {"domain": bcs}, init_val=0.0)
    solver = Solver({"fdm": {"method": "bicgstab", "tol": 1e-10, "max_it": 8000, "report": True,
                             "criterion": "residual", "precond": "mg"}})
    Kt = torch.as_tensor(K, dtype=p().dtype, device=mesh.device)
    solver.set_eq(FDM().laplacian(Kt, p) == torch.zeros_like(p()))
    with SolveTimer() as t:
        rep = solver.solve()

    ph = p()[0].cpu().numpy()
    q_in, q_out = inlet_outlet_flux(K, ph, mesh)
    k_arith = float(np.mean(K))
    k_harm = float(1.0 / np.mean(1.0 / K))
    k_eff = 0.5 * (q_in + q_out)  # dp/L = 1, width 1
    imbalance = abs(q_in - q_out) / abs(q_in)
    print(f"converged={rep['converge']} itr={rep['itr']} tol={float(rep['tol']):.2e} "
          f"(wall {t.elapsed:.3f}s, {mesh.device})")
    print(f"flux in/out: {q_in:.6f} / {q_out:.6f} (imbalance {imbalance:.2e})")
    print(f"K_eff = {k_eff:.4f}  (harmonic {k_harm:.4f} <= K_eff <= arithmetic {k_arith:.4f})")

    if args.plot and (plt := pyplot()) is not None:
        plt.contourf(mesh.X.cpu().numpy(), mesh.Y.cpu().numpy(), ph, levels=30)
        plt.title("Darcy pressure")
        plt.savefig("darcy.png", dpi=120)
        print("wrote darcy.png")
    out = {"demo": "darcy_heterogeneous", "n": n, "dtype": args.dtype, "itr": rep["itr"],
           "tol": rep["tol"], "q_in": q_in, "q_out": q_out, "k_eff": k_eff,
           "k_harmonic": k_harm, "k_arithmetic": k_arith, "wall_s": t.elapsed, "card": gpu,
           "gate": {"converge": bool(rep["converge"]), "flux imbalance < 0.02": imbalance < 0.02,
                    "harmonic <= K_eff <= arithmetic":
                        k_harm - 1e-6 <= k_eff <= k_arith + 1e-6}}
    return finish("darcy_heterogeneous", out, args.json)


if __name__ == "__main__":
    main()
