#!/usr/bin/env python3
"""Boussinesq natural convection in a differentially heated cavity (de
Vahl Davis 1983) through the PyTorch port (the port of
``demos/natural_convection.py``): buoyancy-coupled Navier-Stokes with
implicit heat transport; the hot-wall Nusselt number against the
benchmark.

    python scripts/natural_convection_torch.py [--ra 1e3] [--device cuda] [--json]

The demo's set-up: Ra 1e3, Pr 0.71, 49^2 nodes, 120 steps of dt 0.01 in
chunks of 20 (Nu printed after each). The gate is the JAX test's at Ra
1e3 (``test_natural_convection_davis_ra1e3``): the hot-wall Nu within 3%
of de Vahl Davis' 1.118; at another Ra with a benchmark value (1e4:
2.243, 1e5: 4.519) within 6% (the JAX Ra 1e4 test's tolerance). On the
card, its name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

BENCH = {1e3: 1.118, 1e4: 2.243, 1e5: 4.519}
BENCH_TOL = {1e3: 0.03}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="natural convection (port of "
                                             "demos/natural_convection.py)")
    ap.add_argument("--ra", type=float, default=1e3)
    ap.add_argument("--n", type=int, default=49)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="double", choices=("single", "double"))
    ap.add_argument("--json", action="store_true", help="print one JSON line at the end")
    args = ap.parse_args(argv)

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import NaturalConvection
    from pyapes_tpu_torch.testing.demo import card, finish
    from pyapes_tpu_torch.utils.profile import SolveTimer

    gpu = card(args.device)
    mesh = Mesh(Box[0:1, 0:1], None, [args.n, args.n], device=args.device, dtype=args.dtype)
    model = NaturalConvection(mesh, ra=args.ra, pr=0.71)
    wall = 0.0
    for _ in range(args.steps // 20):
        with SolveTimer() as t:
            model.run(dt=args.dt, n_steps=20)
        wall += t.elapsed
        print(f"t={model.t:.2f}  Nu={model.nusselt_hot_wall():.4f}", flush=True)
    nu = model.nusselt_hot_wall()
    u_max = float(model.u()[0].abs().max())
    ref = BENCH.get(args.ra)
    gate = {"finite": nu == nu and u_max == u_max}
    if ref:
        tol = BENCH_TOL.get(args.ra, 0.06)
        print(f"Nu = {nu:.4f}  (de Vahl Davis: {ref}; diff {100 * abs(nu - ref) / ref:.1f}%)")
        gate[f"|Nu - {ref}| < {tol} * {ref}"] = abs(nu - ref) < tol * ref
    print(f"u_max = {u_max:.3f}; wall {wall:.2f}s for {args.steps // 20 * 20} steps on "
          f"{mesh.device}")
    out = {"demo": "natural_convection", "ra": args.ra, "n": args.n, "dtype": args.dtype,
           "steps": args.steps // 20 * 20, "t": model.t, "nu_hot_wall": nu, "nu_ref": ref,
           "u_max": u_max, "wall_s": wall, "card": gpu, "gate": gate}
    return finish("natural_convection", out, args.json)


if __name__ == "__main__":
    main()
