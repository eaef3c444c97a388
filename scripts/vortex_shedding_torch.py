#!/usr/bin/env python3
"""Vortex shedding behind a circular cylinder at Re 100 — the Strouhal
number — through the PyTorch port (the port of ``demos/vortex_shedding.py``).

    python scripts/vortex_shedding_torch.py [--json]           # 385 x 193, 8000 steps, on the card
    python scripts/vortex_shedding_torch.py --smoke --device cpu   # 97 x 49, 60 steps, on the host

The demo's set-up: ``ChannelFlow`` on Box[0:4, 0:2] with a cylinder of d =
0.2 at (1.0, 1.01) (the 0.01 offset seeds the wake instability), inflow
peak 1.0, nu = d / 100, ``config={"sync": False}``, dt = 0.2 dx / 1.5;
``every`` fused steps per batch (``model.run(dt, every, fused=True)``: on
the card one CUDA graph per step, its solver loops WHILE nodes), then the
staircase lift of the body read on the host, ``C_L = 2 F_y / (U^2 d)``.
St = f d / U from the spectral peak of the developed half of the lift
(~0.16-0.30 depending on the blockage; the smoke run sheds nothing).
Prints the demo's lines and, with ``--json``, one JSON line (with the
card's name and power limit) also written to ``<out>/result.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="97 x 49, 60 steps (no shedding)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="single")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", default="chiprun_out/vortex_shedding")
    args = ap.parse_args()

    import numpy as np

    from pyapes_tpu_torch.geometry import Box, MaskObstacle
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import ChannelFlow

    card = None
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        print(card, flush=True)
    d = 0.2
    u_in, nu = 1.0, d / 100.0  # Re = U d / nu = 100
    nx, ny, steps, every = (97, 49, 60, 10) if args.smoke else (385, 193, 8000, 8)
    body = MaskObstacle(lambda X, Y: (X - 1.0) ** 2 + (Y - 1.01) ** 2 < (d / 2) ** 2)
    mesh = Mesh(Box[0:4, 0:2], [body], [nx, ny], device=args.device, dtype=args.dtype)
    model = ChannelFlow(mesh, nu=nu, u_in=u_in, config={"sync": False})
    dt = 0.2 * (4.0 / (nx - 1)) / 1.5  # CFL ~0.2 at u_max ~ 1.5
    t_hist, cl_hist = [], []
    n_batches = steps // every
    tic = time.perf_counter()
    for i in range(n_batches):
        model.run(dt, every, fused=True)
        F = model.body_force()
        t_hist.append(model.t)
        cl_hist.append(2.0 * F[1] / (u_in**2 * d))
        if (i + 1) % 50 == 0:
            print(f"step {(i + 1) * every}/{steps} t={model.t:.2f} C_L={cl_hist[-1]:+.4f}",
                  flush=True)
    wall = time.perf_counter() - tic

    t_arr, cl = np.asarray(t_hist), np.asarray(cl_hist)
    half = len(cl) // 2
    sig = cl[half:] - cl[half:].mean()
    res = {"nx": nx, "ny": ny, "dtype": args.dtype, "steps": n_batches * every, "dt": dt,
           "wall_s": wall, "wall_s_per_step": wall / (n_batches * every),
           "cell_steps_per_s": nx * ny * n_batches * every / wall, "card": card}
    if len(sig) > 8 and np.abs(sig).max() > 1e-8:
        freqs = np.fft.rfftfreq(len(sig), t_arr[1] - t_arr[0])
        f_shed = float(freqs[1:][np.argmax(np.abs(np.fft.rfft(sig))[1:])])
        res.update({"cl_amp": float(np.abs(sig).max()), "f_shed": f_shed,
                    "St": f_shed * d / u_in})
        print(f"lift oscillation amplitude (developed): {res['cl_amp']:.4f}")
        print(f"shedding frequency f={f_shed:.4f}  ->  St = f d / U = {res['St']:.4f}  "
              "(expected ~0.16-0.30 depending on blockage)")
    else:
        print(f"no developed oscillation detected (max |C_L'| = "
              f"{np.abs(sig).max() if len(sig) else 0:.2e}{'; smoke mode' if args.smoke else ''})")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "result.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    if args.json:
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
