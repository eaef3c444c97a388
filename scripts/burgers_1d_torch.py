#!/usr/bin/env python3
"""1-D viscous Burgers against its travelling-wave exact solution through
the PyTorch port (the port of ``demos/burgers_1d.py``).

    python scripts/burgers_1d_torch.py [--device cuda] [--json] [--plot]

The demo's set-up: 201 nodes on [0, 2 pi], nu 0.1, 50 implicit steps of
dt 2e-3; the gate is the JAX model test's, relative L2 error against
``burger_exact_nd`` below 0.05. On the card, its name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys
from math import pi

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="1-D viscous Burgers (port of demos/burgers_1d.py)")
    ap.add_argument("--n", type=int, default=201)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--dt", type=float, default=0.002)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="double", choices=("single", "double"))
    ap.add_argument("--json", action="store_true", help="print one JSON line at the end")
    ap.add_argument("--plot", action="store_true", help="write burgers.png (needs matplotlib)")
    args = ap.parse_args(argv)

    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import Burgers1D
    from pyapes_tpu_torch.testing.burgers import burger_exact_nd
    from pyapes_tpu_torch.testing.demo import card, finish, pyplot
    from pyapes_tpu_torch.utils.profile import SolveTimer

    gpu = card(args.device)
    mesh = Mesh(Box[0:2 * pi], None, [args.n], device=args.device, dtype=args.dtype)
    model = Burgers1D(mesh, nu=0.1)
    u0 = model.var()[0].cpu()
    with SolveTimer() as t:
        for _ in range(args.steps):
            model.step(args.dt)
    u = model.var()[0]
    ex = burger_exact_nd(mesh, 0.1, model.var.t)
    err = (torch.linalg.vector_norm(u - ex) / torch.linalg.vector_norm(ex)).item()
    print(f"t={model.var.t:.3f} relative L2 error vs exact: {err:.4f} "
          f"(wall {t.elapsed:.2f}s, {args.steps} steps, {mesh.device})")

    if args.plot and (plt := pyplot()) is not None:
        x = mesh.X.cpu().numpy()
        plt.plot(x, u0.numpy(), label="t=0")
        plt.plot(x, u.cpu().numpy(), label=f"t={model.var.t:.2f}")
        plt.plot(x, ex.cpu().numpy(), "--", label="exact")
        plt.legend()
        plt.savefig("burgers.png", dpi=120)
        print("wrote burgers.png")
    out = {"demo": "burgers_1d", "n": args.n, "dtype": args.dtype, "steps": args.steps,
           "t": model.var.t, "rel_l2": err, "wall_s": t.elapsed, "card": gpu,
           "gate": {"rel_l2 < 0.05": err < 0.05}}
    return finish("burgers_1d", out, args.json)


if __name__ == "__main__":
    main()
