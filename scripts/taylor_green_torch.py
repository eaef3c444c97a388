#!/usr/bin/env python3
"""The decaying 2-D Taylor-Green vortex through the PyTorch port (the port
of ``demos/taylor_green.py``): an exact transient Navier-Stokes solution on
the fully periodic box,

    u = -cos(2 pi x) sin(2 pi y) exp(-8 pi^2 nu t)
    v =  sin(2 pi x) cos(2 pi y) exp(-8 pi^2 nu t)

whose nonlinear term is a pure gradient absorbed by the pressure: every
digit of disagreement is solver error (stencils, projection splitting,
the periodic seam).

    python scripts/taylor_green_torch.py [--device cuda] [--dtype double] [--json]

The demo's set-up: 65^2 nodes, nu 0.01, dt 2e-3, 250 eager steps, the
kinetic energy against the exact one every 50 steps and the final
velocity's relative L2 error; on the card, its name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from math import exp, pi

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="double", choices=("single", "double"))
    ap.add_argument("--json", action="store_true", help="print one JSON line at the end")
    args = ap.parse_args()

    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import PeriodicFlow

    card = None
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        print(card, flush=True)
    n, nu = args.n, 0.01
    mesh = Mesh(Box[0:1, 0:1], None, [n, n], device=args.device, dtype=args.dtype)
    model = PeriodicFlow(mesh, nu=nu)
    k = 2 * pi
    u0 = -torch.cos(k * mesh.X) * torch.sin(k * mesh.Y)
    v0 = torch.sin(k * mesh.X) * torch.cos(k * mesh.Y)
    model.set_velocity(u0, v0)

    dt, steps, every = 2e-3, 250, 50
    print(f"Taylor-Green {n}x{n}, nu={nu}, dt={dt}, device {mesh.device} {args.dtype}")
    print(f"{'t':>6} {'KE (solved)':>12} {'KE (exact)':>12} {'rel err':>9}")
    ke_err = []
    tic = time.perf_counter()
    for _ in range(0, steps, every):
        model.run(dt, every)
        ke = float(model.kinetic_energy())
        ke_ex = 0.25 * exp(-4 * k**2 * nu * model.t)
        ke_err.append(abs(ke / ke_ex - 1))
        print(f"{model.t:6.3f} {ke:12.6f} {ke_ex:12.6f} {ke_err[-1]:9.2e}", flush=True)
    wall = time.perf_counter() - tic
    decay = exp(-2 * k**2 * nu * model.t)
    rel = ((model.u()[0] - u0 * decay).norm() / (u0.norm() * decay)).item()
    print(f"final velocity rel L2 error vs exact: {rel:.2e}")
    print(f"wall {wall:.2f}s for {steps} steps ({wall / steps * 1e3:.2f} ms per step)")
    if args.json:
        print(json.dumps({"n": n, "dtype": args.dtype, "steps": steps, "t": model.t,
                          "rel_l2_u": rel, "ke_rel_err": ke_err, "wall_s": wall,
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
