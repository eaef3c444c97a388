#!/usr/bin/env python3
"""The 2-D lid-driven cavity at Re = 100 (Chorin projection) through the
PyTorch port (the port of ``demos/lid_driven_cavity.py``).

    python scripts/lid_driven_cavity_torch.py [--device cuda] [--fused] [--json] [--plot]

The demo's set-up: 65^2 nodes, nu 0.01, lid velocity 1, 600 eager steps
of dt 0.01 (``--fused``: the fused whole-step runner). Gates: the JAX
cavity test's (the lid and the bottom wall enforced to 1e-12, the
vertical centreline's u below -0.05, the horizontal centreline's v above
0.02 and below -0.02); the centreline u minimum is printed beside Ghia et
al.'s converged Re = 100 value -0.2109 (at the demo's set-up it lies
within the JAX Ghia test's 0.03). On the card, its name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

GHIA_U_MIN = -0.2109


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="lid-driven cavity Re=100 (port of "
                                             "demos/lid_driven_cavity.py)")
    ap.add_argument("--n", type=int, default=65)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--fused", action="store_true", help="the fused whole-step runner")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="double", choices=("single", "double"))
    ap.add_argument("--json", action="store_true", help="print one JSON line at the end")
    ap.add_argument("--plot", action="store_true", help="write cavity.png")
    args = ap.parse_args(argv)

    import numpy as np

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import LidDrivenCavity
    from pyapes_tpu_torch.testing.demo import card, finish, pyplot
    from pyapes_tpu_torch.utils.profile import SolveTimer

    gpu = card(args.device)
    n = args.n
    mesh = Mesh(Box[0:1, 0:1], None, [n, n], device=args.device, dtype=args.dtype)
    model = LidDrivenCavity(mesh, nu=0.01, lid_velocity=1.0)
    with SolveTimer() as t:
        model.run(dt=args.dt, n_steps=args.steps, fused=args.fused)
    u = model.u()[0].cpu().numpy()
    v = model.v()[0].cpu().numpy()
    mid = n // 2
    u_min = float(u[mid, :].min())
    print(f"t={model.t:.2f}  u centerline min={u_min:.4f} (Ghia et al. Re=100 converged: "
          f"{GHIA_U_MIN}); wall {t.elapsed:.2f}s for {args.steps} steps on {mesh.device}")

    if args.plot and (plt := pyplot()) is not None:
        speed = np.sqrt(u**2 + v**2)
        X, Y = mesh.X.cpu().numpy(), mesh.Y.cpu().numpy()
        plt.streamplot(X.T, Y.T, u.T, v.T, color=speed.T, density=1.5)
        plt.title("Lid-driven cavity, Re=100")
        plt.savefig("cavity.png", dpi=120)
        print("wrote cavity.png")
    out = {"demo": "lid_driven_cavity", "n": n, "dtype": args.dtype, "steps": args.steps,
           "fused": args.fused, "t": model.t, "u_min": u_min, "ghia_u_min": GHIA_U_MIN,
           "v_max": float(v[:, mid].max()), "v_min": float(v[:, mid].min()),
           "wall_s": t.elapsed, "ms_per_step": t.elapsed / args.steps * 1e3, "card": gpu,
           "gate": {"lid u = 1": bool(np.abs(u[:, -1][1:-1] - 1.0).max() <= 1e-12),
                    "bottom u = 0": bool(np.abs(u[:, 0]).max() <= 1e-12),
                    "u_min < -0.05": u_min < -0.05,
                    "v_max > 0.02": float(v[:, mid].max()) > 0.02,
                    "v_min < -0.02": float(v[:, mid].min()) < -0.02}}
    return finish("lid_driven_cavity", out, args.json)


if __name__ == "__main__":
    main()
