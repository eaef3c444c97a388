#!/usr/bin/env python3
"""Permeability inversion through the PyTorch port (the port of
``demos/darcy_inversion.py``): recover K(x) from sparse pressure data.

The forward map ``p = A(K)^-1 rhs`` is ``DifferentiableDiffusionSolve``:
the data misfit's gradient reaches the per-point log K through one
adjoint solve per evaluation; on the card every matvec is the variable-Γ
kernel. ``torch.optim.Adam(lr=0.05)`` stands in for ``optax.adam(0.05)``
(the same defaults).

    python scripts/darcy_inversion_torch.py [--n 33] [--iters 300] [--device cpu]

The demo's gates: the misfit below 2% of its start, K inside the
inclusion under 0.6 and the background within 0.25 of 1.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adjoint_inverse_source_torch import card_line  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=33)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--stride", type=int, default=2, help="sensor spacing (every stride-th node)")
    ap.add_argument("--tv", type=float, default=1e-5, help="total-variation weight")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    card_line(args.device)

    import numpy as np
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.solver.adjoint import DifferentiableDiffusionSolve
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    n = args.n
    mesh = Mesh(Box[0:1, 0:1], None, [n, n], device=args.device, dtype="double")
    X, Y = (np.asarray(g) for g in mesh._grid_np)
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(2, 0.0, "dirichlet")}, init_val=0.0)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=mesh.device)

    k_true = np.where((X - 0.6) ** 2 + (Y - 0.45) ** 2 < 0.18**2, 0.25, 1.0)
    rhs = dev(np.ones_like(X))[None]  # uniform injection
    dsolve = DifferentiableDiffusionSolve(mesh, var.bcs, tol=1e-10, symmetric=True)
    p_true = dsolve(dev(k_true), rhs)

    s = args.stride
    mask = np.zeros_like(X, bool)
    mask[s:-s:s, s:-s:s] = True
    obs_mask = dev(mask[None])
    p_obs = p_true * obs_mask

    def tv(theta):
        return torch.sum(torch.abs(torch.diff(theta, dim=0))) + torch.sum(
            torch.abs(torch.diff(theta, dim=1)))

    def misfit(theta):
        return torch.sum((dsolve(torch.exp(theta), rhs) * obs_mask - p_obs) ** 2)

    theta = torch.zeros((n, n), dtype=torch.float64, device=mesh.device, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=0.05)
    with torch.no_grad():
        m0 = float(misfit(theta))
    tic = time.perf_counter()
    for it in range(args.iters):
        opt.zero_grad()
        loss = misfit(theta) + args.tv * tv(theta)
        loss.backward()
        opt.step()
        if it % 50 == 0:
            print(f"iter {it:4d}  loss {float(loss):.3e}", flush=True)
    wall = time.perf_counter() - tic

    k_rec = torch.exp(theta).detach().cpu().numpy()
    inside = (X - 0.6) ** 2 + (Y - 0.45) ** 2 < 0.14**2
    far = (X - 0.6) ** 2 + (Y - 0.45) ** 2 > 0.3**2
    interior = (X > 0.05) & (X < 0.95) & (Y > 0.05) & (Y < 0.95)
    k_in = float(k_rec[inside].mean())
    k_out = float(k_rec[far & interior].mean())
    with torch.no_grad():
        m1 = float(misfit(theta))
    print(f"sensors: {int(mask.sum())} / {n * n} nodes")
    print(f"data misfit: {m0:.3e} -> {m1:.3e}")
    print(f"recovered K inside inclusion: {k_in:.3f} (true 0.25)")
    print(f"recovered K background:       {k_out:.3f} (true 1.00)")
    print(f"{args.iters} value-and-gradient evaluations in {wall:.2f} s on {mesh.device}")
    assert m1 < 0.02 * m0, (m0, m1)
    assert k_in < 0.6 and abs(k_out - 1.0) < 0.25, (k_in, k_out)
    print("OK")


if __name__ == "__main__":
    main()
