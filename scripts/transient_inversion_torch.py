#!/usr/bin/env python3
"""Transient inverse problems through the PyTorch port (the port of
``demos/transient_inversion.py``): recover an unknown diffusivity ν and a
per-point conductivity Γ(x) from one observed endpoint of a transient
heat run; gradients flow through N implicit solves, one adjoint solve per
step, each step recomputed in the backward sweep.

    python scripts/transient_inversion_torch.py [--device cpu]

Gates: ν within 1e-4 of 0.08 (``tests/test_adjoint.py``'s
``test_recover_nu_from_trajectory`` gate); for Γ the endpoint misfit
falls below 2% of its start and the recovered Γ is lower inside the
inclusion than outside it.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adjoint_inverse_source_torch import card_line  # noqa: E402


def _heat_mesh(n, device):
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import mixed_bcs

    mesh = Mesh(Box[0:1, 0:1], None, [n, n], device=device, dtype="double")
    var = Field("T", 1, mesh, {"domain": mixed_bcs([0.0] * 4, ["dirichlet"] * 4),
                               "obstacle": None})
    return mesh, var


def recover_nu(device) -> float:
    print("=== scalar diffusivity from one endpoint (secant on grad) ===")
    import numpy as np
    import torch

    from pyapes_tpu_torch.ops.stencil import laplacian_axis_coeffs
    from pyapes_tpu_torch.solver.adjoint import DifferentiableTransient

    n, dt, n_steps = 17, 0.02, 6
    mesh, var = _heat_mesh(n, device)
    lap = tuple(tuple(torch.as_tensor(c, device=mesh.device) for c in cs)
                for cs in laplacian_axis_coeffs(mesh, var.bcs))
    roll = DifferentiableTransient(
        mesh, var.bcs, lambda nu: tuple((-nu * ap, -nu * ac, -nu * am) for ap, ac, am in lap),
        dt=dt, tol=1e-12)
    x0 = torch.as_tensor(np.random.default_rng(0).standard_normal((1, n, n)), device=mesh.device)
    nu_true = 0.08
    obs = roll(torch.tensor(nu_true, dtype=torch.float64, device=mesh.device), x0, n_steps)

    def gfn(nu):
        v = torch.tensor(nu, dtype=torch.float64, device=mesh.device, requires_grad=True)
        (g,) = torch.autograd.grad(torch.sum((roll(v, x0, n_steps) - obs) ** 2), v)
        return float(g)

    nu0, nu1 = 0.02, 0.04
    g0 = gfn(nu0)
    for it in range(12):
        g1 = gfn(nu1)
        if g1 == g0 or abs(nu1 - nu0) < 1e-12:
            break
        nu0, nu1, g0 = nu1, nu1 - g1 * (nu1 - nu0) / (g1 - g0), g1
        print(f"  it {it}: nu = {nu1:.6f}")
    err = abs(nu1 - nu_true)
    print(f"  recovered nu = {nu1:.6f} (true {nu_true}) error {err:.2e}")
    assert err < 1e-4, nu1
    return nu1


def recover_gamma(device) -> None:
    print("=== per-point Gamma(x) from one endpoint (adam) ===")
    import numpy as np
    import torch

    from pyapes_tpu_torch.solver.adjoint import DifferentiableTransientDiffusion

    n, dt, n_steps = 17, 0.02, 4
    mesh, var = _heat_mesh(n, device)
    roll = DifferentiableTransientDiffusion(mesh, var.bcs, dt=dt, tol=1e-12)
    X, Y = (np.asarray(g) for g in mesh._grid_np)
    inside = (X - 0.5) ** 2 + (Y - 0.5) ** 2 < 0.2**2
    g_true = torch.as_tensor(np.where(inside, 0.3, 1.0), device=mesh.device)
    x0 = torch.as_tensor(np.random.default_rng(1).standard_normal((1, n, n)), device=mesh.device)
    obs = roll(g_true, x0, n_steps)

    def loss(theta):
        return torch.sum((roll(torch.exp(theta), x0, n_steps) - obs) ** 2)

    theta = torch.zeros((n, n), dtype=torch.float64, device=mesh.device, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=0.1)
    with torch.no_grad():
        l0 = float(loss(theta))
    for _ in range(80):
        opt.zero_grad()
        loss(theta).backward()
        opt.step()
    with torch.no_grad():
        l1 = float(loss(theta))
    g_rec = torch.exp(theta).detach().cpu().numpy()
    g_in, g_out = float(g_rec[inside].mean()), float(g_rec[~inside].mean())
    print(f"  loss {l0:.3e} -> {l1:.3e}")
    print(f"  recovered Gamma inside inclusion: {g_in:.3f} (true 0.3), outside: {g_out:.3f} "
          "(true 1.0)")
    assert l1 < 0.02 * l0 and g_in < g_out, (l0, l1, g_in, g_out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    card_line(args.device)
    recover_nu(args.device)
    recover_gamma(args.device)
    print("OK")


if __name__ == "__main__":
    main()
