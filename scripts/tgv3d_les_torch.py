#!/usr/bin/env python3
"""The 3-D Taylor-Green vortex at Re 1600 with Smagorinsky LES through the
PyTorch port on one NVIDIA GPU (the port of ``demos/tgv3d_les.py``).

    python scripts/tgv3d_les_torch.py [--n 64] [--t-end 12] [--no-les] [--eager] [--json] [--out chiprun_out/tgv3d]
    python scripts/tgv3d_les_torch.py --n 17 --t-end 1 --device cpu   # a small run on the host

The demo's set-up: ``u = sin x cos y cos z``, ``v = -cos x sin y cos z``,
``w = 0`` on [0, 2 pi]^3 (n nodes per axis, f32), nu = 1/Re, the
Smagorinsky closure (cs 0.17) as the model's ``mu_strain_fn``, the
skew-symmetric advection form (the ``PeriodicFlow`` default), dt = cfl
dx; the volume-averaged kinetic energy <E>(t) sampled every ``sample-dt``
and the total dissipation eps = -d<E>/dt on the sample midpoints. The
steps are fused by default, as the demo's (``model.run(dt, every,
fused=True)``: on the card one CUDA graph per step, its solver loops
WHILE nodes); ``--eager`` steps eagerly. One host read per sample.

DNS reference (van Rees et al. 2011, 512^3 spectral): eps_max ~ 0.0122 at
t ~ 9.0; the JAX package's record at 64^3: 0.0108 at t = 7.65
(``demos/tgv3d_les.py``). Prints the demo's table and summary, the card's
name and power limit, and with ``--json`` the demo's JSON line (plus the
card and the JAX test's gates: 0.008 < eps_max < 0.0135, 6 < t_peak < 10,
final <E> < 0.07), also written to ``<out>/result.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from math import pi

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64, help="grid nodes per axis")
    ap.add_argument("--re", type=float, default=1600.0)
    ap.add_argument("--cs", type=float, default=0.17, help="Smagorinsky constant")
    ap.add_argument("--t-end", type=float, default=12.0)
    ap.add_argument("--cfl", type=float, default=0.2)
    ap.add_argument("--sample-dt", type=float, default=0.25, help="time between E(t) samples")
    ap.add_argument("--no-les", action="store_true", help="no SGS closure (coarse DNS)")
    ap.add_argument("--eager", action="store_true",
                    help="eager steps instead of the fused whole-step runner")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true", help="print one JSON line at the end")
    ap.add_argument("--out", default="chiprun_out/tgv3d")
    args = ap.parse_args()

    import numpy as np
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import PeriodicFlow, smagorinsky_viscosity

    card = None
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        print(card, flush=True)
    n, L, nu = args.n, 2 * pi, 1.0 / args.re
    mesh = Mesh(Box[0:L, 0:L, 0:L], None, [n, n, n], device=args.device, dtype="single")
    mu_fn = None if args.no_les else smagorinsky_viscosity(nu, mesh, cs=args.cs)
    model = PeriodicFlow(mesh, nu=nu, mu_strain_fn=mu_fn)
    X, Y, Z = mesh.X, mesh.Y, mesh.Z
    model.set_velocity(torch.sin(X) * torch.cos(Y) * torch.cos(Z),
                       -torch.cos(X) * torch.sin(Y) * torch.cos(Z), torch.zeros_like(X))

    vol = L**3
    dt = args.cfl * L / (n - 1)  # |u|_max = 1 initially, decaying from there
    every = max(1, int(round(args.sample_dt / dt)))
    n_windows = int(np.ceil(args.t_end / (every * dt)))
    ts, Es = [0.0], [float(model.kinetic_energy()) / vol]
    print(f"TGV-3D {n}^3, Re={args.re:g}, "
          f"{'Smagorinsky cs=%g' % args.cs if mu_fn else 'no-model'}, "
          f"dt={dt:.4f} ({every} steps/sample), device {mesh.device}, "
          f"{'eager' if args.eager else 'fused'}")
    print(f"{'t':>7} {'<E>':>10} {'eps=-dE/dt':>11}")
    tic = time.perf_counter()
    tic1 = None
    for _ in range(n_windows):
        model.run(dt, every, fused=not args.eager)
        if tic1 is None:  # after the first window: kernels built, the graph captured
            tic1 = time.perf_counter()
        ts.append(model.t)
        Es.append(float(model.kinetic_energy()) / vol)
        eps = -(Es[-1] - Es[-2]) / (ts[-1] - ts[-2])
        print(f"{model.t:7.3f} {Es[-1]:10.6f} {eps:11.6f}", flush=True)
    wall = time.perf_counter() - tic

    ts_np, es = np.asarray(ts), np.asarray(Es)
    eps_t = -(es[1:] - es[:-1]) / (ts_np[1:] - ts_np[:-1])
    t_mid = 0.5 * (ts_np[1:] + ts_np[:-1])
    i_pk = int(np.argmax(eps_t))
    eps_max, t_pk = float(eps_t[i_pk]), float(t_mid[i_pk])
    print(f"\npeak total dissipation: eps_max = {eps_max:.5f} at t = {t_pk:.2f}")
    print("DNS reference (van Rees 2011, 512^3 spectral): eps_max ~ 0.0122 at t ~ 9.0")
    n_steps = every * n_windows
    print(f"wall {wall:.1f}s for {n_steps} steps ({n**3 * n_steps / wall:.3g} cell-steps/s)")
    res = {
        "n": n, "re": args.re, "les": mu_fn is not None, "fused": not args.eager,
        "eps_max": eps_max, "t_peak": t_pk,
        "E0": float(es[0]), "E_end": float(es[-1]), "t_end": float(ts_np[-1]), "steps": n_steps,
        "wall_s": wall, "cell_steps_per_s": n**3 * n_steps / wall, "card": card,
        "wall_s_per_step_after_first_window": (tic + wall - tic1) / (n_steps - every),
        "gates": {"eps_max": 0.008 < eps_max < 0.0135, "t_peak": 6.0 < t_pk < 10.0,
                  "E_end": float(es[-1]) < 0.07, "energy_decays": bool(np.all(np.diff(es) < 0))},
        "series": {"t": ts_np.tolist(), "E": es.tolist()},
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "result.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    if args.json:
        print(json.dumps({k: v for k, v in res.items() if k != "series"}), flush=True)


if __name__ == "__main__":
    main()
