#!/usr/bin/env python3
"""Differentiable-solve demo through the PyTorch port (the port of
``demos/adjoint_inverse_source.py``): recover the amplitudes of three
Poisson sources from the observed solution by gradient descent.

Every gradient costs one extra (adjoint) solve (``DifferentiableSolve``,
``pyapes_tpu_torch/solver/adjoint.py``); on the card each forward and
adjoint matvec is the axis stencil kernel.

    python scripts/adjoint_inverse_source_torch.py [--device cpu]

The demo's set-up and gate: 33^2 nodes, homogeneous Dirichlet, tol 1e-10,
300 steps of lr 5e3; the amplitudes within 1e-2 of (-3, 1.5, 2).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_line(device: str) -> None:
    """Print the card's name and power limit (``nvidia-smi``) unless on
    the CPU."""
    if device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    card_line(args.device)

    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.ops.stencil import laplacian_axis_coeffs
    from pyapes_tpu_torch.solver import DifferentiableSolve
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    n = 33
    mesh = Mesh(Box[0:1, 0:1], None, [n, n], device=args.device, dtype="double")
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(2, 0.0, "dirichlet"),
                               "obstacle": None})
    coeffs = tuple(tuple(torch.as_tensor(c, device=mesh.device) for c in cs)
                   for cs in laplacian_axis_coeffs(mesh, var.bcs))
    dsolve = DifferentiableSolve(mesh, var.bcs, tol=1e-10)

    locs = [(8, 24), (16, 10), (25, 20)]
    basis = torch.zeros((3, 1, n, n), dtype=torch.float64, device=mesh.device)
    for k, (i, j) in enumerate(locs):
        basis[k, 0, i, j] = 1.0
    a_true = torch.tensor([-3.0, 1.5, 2.0], dtype=torch.float64, device=mesh.device)
    x_obs = dsolve(coeffs, torch.einsum("k,kcij->cij", a_true, basis))

    def loss(a):
        return torch.sum((dsolve(coeffs, torch.einsum("k,kcij->cij", a, basis)) - x_obs) ** 2)

    a = torch.zeros(3, dtype=torch.float64, device=mesh.device)
    lr = 5e3
    tic = time.perf_counter()
    for it in range(300):
        a = a.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(a), a)
        a = a.detach() - lr * g
        if it % 50 == 0:
            print(f"it {it:3d}  loss {float(loss(a)):.3e}  a {a.tolist()}", flush=True)
    wall = time.perf_counter() - tic
    print(f"recovered: {a.tolist()}  true: {a_true.tolist()}  ({wall:.2f} s for 300 gradients "
          f"on {mesh.device}; itr forward {dsolve.itr['forward']} adjoint "
          f"{dsolve.itr['adjoint']})")
    assert torch.allclose(a, a_true, atol=1e-2, rtol=0.0), a.tolist()
    print("OK")


if __name__ == "__main__":
    main()
