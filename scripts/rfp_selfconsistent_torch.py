#!/usr/bin/env python3
"""Self-consistent Rosenbluth-Fokker-Planck relaxation through the PyTorch
port (the port of ``demos/rfp_selfconsistent.py``): an anisotropic
(T_perp != T_par) velocity distribution relaxes toward isotropy under
like-species collisions, the potentials H, G re-solved from f every
``refresh`` steps.

    python scripts/rfp_selfconsistent_torch.py [--device cuda] [--json]

The demo's set-up: the (r, z) cylinder [0, 4.5] x [-4.5, 4.5] of 48 x 96
nodes, T_perp 0.36, T_par 1 at unit density, 5 chunks of 150 explicit
steps of dt 2e-4 with a refresh every 20. Gates: the JAX relaxation
test's (every value finite, density kept to 5e-3, the anisotropy below
0.95 of its start, the temperatures moving toward each other and not
past). On the card, its name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def moments(mesh, f):
    """Density and the perpendicular / parallel temperatures of ``f``."""
    import numpy as np

    R, Z = (np.asarray(g) for g in mesh._grid_np)
    dr, dz = (float(d) for d in mesh.dx_np)
    w = 2.0 * np.pi * R * dr * dz
    f = np.asarray(f)
    N = (f * w).sum()
    return N, (f * R**2 * w).sum() / N / 2.0, (f * Z**2 * w).sum() / N


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="self-consistent RFP relaxation (port of "
                                             "demos/rfp_selfconsistent.py)")
    ap.add_argument("--nr", type=int, default=48)
    ap.add_argument("--nz", type=int, default=96)
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=150)
    ap.add_argument("--dt", type=float, default=2e-4)
    ap.add_argument("--refresh", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="double", choices=("single", "double"))
    ap.add_argument("--json", action="store_true", help="print one JSON line at the end")
    args = ap.parse_args(argv)

    import numpy as np

    from pyapes_tpu_torch.geometry import Cylinder
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import RFPEvolution
    from pyapes_tpu_torch.testing.demo import card, finish
    from pyapes_tpu_torch.utils.profile import SolveTimer
    from pyapes_tpu_torch.variables import Field

    gpu = card(args.device)
    mesh = Mesh(Cylinder[0:4.5, -4.5:4.5], None, [args.nr, args.nz], device=args.device,
                dtype=args.dtype)
    R, Z = (np.asarray(g) for g in mesh._grid_np)
    t_perp, t_par = 0.36, 1.0
    # normalized to unit density: the collision rate and the explicit
    # stability limit both scale with N
    f0 = np.exp(-(R**2) / (2 * t_perp) - Z**2 / (2 * t_par))
    f0 /= (2 * np.pi * t_perp) * np.sqrt(2 * np.pi * t_par)
    f = Field("pdf", 1, mesh, None)
    f.set_var_tensor(f0)
    model = RFPEvolution(mesh)

    N0, tp0, tz0 = moments(mesh, f0)
    print(f"t=0.00  N={N0:.5f}  T_perp={tp0:.4f}  T_par={tz0:.4f}")
    wall = 0.0
    for k in range(1, args.chunks + 1):
        with SolveTimer() as t:
            f = model.run_selfconsistent(f, dt=args.dt, n_steps=args.chunk,
                                         refresh_every=args.refresh)
        wall += t.elapsed
        N, tp, tz = moments(mesh, f()[0].cpu().numpy())
        print(f"t={k * args.chunk * args.dt:.2f}  N={N:.5f}  T_perp={tp:.4f}  T_par={tz:.4f}  "
              f"anisotropy={abs(tz - tp):.4f}", flush=True)
    v = f()[0].cpu().numpy()
    steps = args.chunks * args.chunk
    print(f"wall {wall:.2f}s for {steps} steps ({wall / steps * 1e3:.2f} ms per step) on "
          f"{mesh.device}")
    out = {"demo": "rfp_selfconsistent", "cells": [args.nr, args.nz], "dtype": args.dtype,
           "steps": steps, "N0": N0, "N": N, "T_perp": [tp0, tp], "T_par": [tz0, tz],
           "wall_s": wall, "card": gpu,
           "gate": {"finite": bool(np.all(np.isfinite(v))),
                    "|N - N0| < 5e-3 N0": abs(N - N0) / N0 < 5e-3,
                    "anisotropy < 0.95 of its start": abs(tz - tp) < 0.95 * abs(tz0 - tp0),
                    "T_perp0 - 1e-3 < T_perp < T_par < T_par0 + 1e-3":
                        tp0 - 1e-3 < tp < tz < tz0 + 1e-3}}
    return finish("rfp_selfconsistent", out, args.json)


if __name__ == "__main__":
    main()
