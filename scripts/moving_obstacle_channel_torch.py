#!/usr/bin/env python3
"""Channel flow past a translating square body (a moving immersed
boundary) through the PyTorch port (the port of
``demos/moving_obstacle_channel.py``): direct forcing pins the velocity to
the body's inside a DYNAMIC obstacle-Dirichlet mask, read again at every
solve as the body moves.

    python scripts/moving_obstacle_channel_torch.py [--device cuda] [--json]

The demo's set-up: a 3 x 1 channel of (3n - 2) x n nodes (n 49), nu 0.02,
inflow 1, Rhie-Chow; a square body of half-width 0.08 from (0.6, 0.5)
moving at +0.25 along x; 120 steps of dt 5e-3, the fluxes, the mean
|div u| and the body's drag and lift every 30 steps. Gates (the JAX
channel tests' checks on these numbers): every value finite, every solve
converged, inflow and outflow fluxes within 5% of each other, and the
velocity inside the body equal to the body's. On the card, its name and
power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def body_mask(mesh, xc, yc, half):
    import numpy as np

    X, Y = (np.asarray(g) for g in mesh._grid_np[:2])
    return (np.abs(X - xc) <= half) & (np.abs(Y - yc) <= half)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="moving-body channel (port of "
                                             "demos/moving_obstacle_channel.py)")
    ap.add_argument("--n", type=int, default=49)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--every", type=int, default=30)
    ap.add_argument("--dt", type=float, default=0.005)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="double", choices=("single", "double"))
    ap.add_argument("--json", action="store_true", help="print one JSON line at the end")
    args = ap.parse_args(argv)

    import math

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import ChannelFlow
    from pyapes_tpu_torch.models.navier_stokes import staircase_body_force
    from pyapes_tpu_torch.solver.ops import solve_log
    from pyapes_tpu_torch.testing.demo import card, finish
    from pyapes_tpu_torch.utils.profile import SolveTimer
    from pyapes_tpu_torch.variables.bcs import ObstacleDirichlet

    gpu = card(args.device)
    n = args.n
    mesh = Mesh(Box[0:3, 0:1], None, [3 * n - 2, n], device=args.device, dtype=args.dtype)
    model = ChannelFlow(mesh, nu=0.02, u_in=1.0, rhie_chow=True)
    half, xc, yc, u_body = 0.08, 0.6, 0.5, 0.25
    m0 = body_mask(mesh, xc, yc, half)
    obs = [ObstacleDirichlet(f"body-{v.name}", 0.0, m0, dynamic=True) for v in model.vel]
    for v, ob in zip(model.vel, obs):
        v.bcs.append(ob)

    rows, wall, converged, n_solves = [], 0.0, True, 0
    for i in range(args.steps):
        x_now = xc + u_body * model.t
        m = body_mask(mesh, x_now, yc, half)
        for j, ob in enumerate(obs):
            ob.bc_mask = m
            ob.bc_val = u_body if j == 0 else 0.0  # the body moves along +x
        with SolveTimer() as t, solve_log() as reports:
            model.step(args.dt)
        wall += t.elapsed
        n_solves += len(reports)
        converged = converged and all(bool(r["converge"]) for r in reports)
        if (i + 1) % args.every == 0 or i + 1 == args.steps:
            div = float(model.divergence().abs().mean())
            drag, lift = staircase_body_force(model.p()[0], [v()[0] for v in model.vel], m,
                                              [float(d) for d in mesh.dx_np], model.nu,
                                              u_body=[u_body, 0.0])
            row = {"step": i + 1, "x_body": x_now, "flux_in": model.flux(0),
                   "flux_out": model.flux(-1), "mean_abs_div": div, "drag": float(drag),
                   "lift": float(lift)}
            rows.append(row)
            print(f"step {i + 1}: body at x={x_now:.3f}, flux_in={row['flux_in']:.4f} "
                  f"flux_out={row['flux_out']:.4f} mean|div|={div:.2e} drag={drag:+.3f} "
                  f"lift={lift:+.3f}", flush=True)
    last = rows[-1]
    u_in_body = model.vel[0]()[0].cpu().numpy()[m]
    v_in_body = model.vel[1]()[0].cpu().numpy()[m]
    body_err = float(max(abs(u_in_body - u_body).max(), abs(v_in_body).max()))
    finite = all(math.isfinite(v) for r in rows for v in r.values())
    print(f"wall {wall:.2f}s for {args.steps} steps ({wall / args.steps * 1e3:.2f} ms per step) "
          f"on {mesh.device}; {n_solves} solves")
    out = {"demo": "moving_obstacle_channel", "n": n, "dtype": args.dtype, "steps": args.steps,
           "rows": rows, "body_velocity_err": body_err, "wall_s": wall, "card": gpu,
           "gate": {"finite": finite, "every solve converged": converged,
                    "|flux_out - flux_in| < 0.05 flux_in":
                        abs(last["flux_out"] - last["flux_in"]) < 0.05 * abs(last["flux_in"]),
                    "body velocity pinned (1e-8)": body_err < 1e-8}}
    return finish("moving_obstacle_channel", out, args.json)


if __name__ == "__main__":
    main()
