"""Simulation runner / CLI (port of ``pyapes_tpu/runner.py``; the
``poisson`` subcommand).

    python -m pyapes_tpu_torch.runner poisson --dim 3 --n 512 --device cuda
    python -m pyapes_tpu_torch.runner poisson --dim 3 --n 512 --mg --device cuda

``--mg`` asks for MG-preconditioned CG explicitly (``method: "cg",
precond: "mg"``); without it the separable problem takes the fastdiag
direct solve. (The JAX runner's ``--mg`` only sets ``precond`` and reaches
MG-PCG through a fault of its fastdiag probe; see ROADMAP.)

prints one JSON line ``{"report": {...}, "wall_s": ..., "n": ...}``, the
JAX runner's shape. ``wall_s`` is the host wall time of the solve, ending
after the solution is on the device (the solve reads its tolerance back
every pass, and the runner synchronises before stopping the clock).
"""
from __future__ import annotations

import argparse
import json
import time


def _run_poisson(args) -> dict:
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import PoissonSolver
    from pyapes_tpu_torch.testing.poisson import poisson_bcs, poisson_rhs_nd

    box = Box[tuple(slice(0, 1) for _ in range(args.dim))]
    mesh = Mesh(box, None, [args.n] * args.dim, device=args.device, dtype=args.dtype)
    cfg = {"tol": args.tol, "max_it": args.max_it}
    if args.mg:
        cfg.update({"method": "cg", "precond": "mg"})
    model = PoissonSolver(mesh, poisson_bcs(args.dim), config=cfg)
    rhs = poisson_rhs_nd(mesh, model.var)
    tic = time.perf_counter()
    model.solve(rhs)
    if mesh.is_cuda:
        torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - tic
    return {"report": dict(model.report), "wall_s": wall, "n": args.n}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="pyapes_tpu_torch.runner")
    sub = p.add_subparsers(dest="case", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--n", type=int, default=65)
    common.add_argument("--dtype", default="single")
    common.add_argument("--tol", type=float, default=1e-6)
    common.add_argument("--max-it", type=int, default=2000)
    common.add_argument(
        "--device", default="cpu", choices=["cpu", "cuda", "gpu"],
        help="torch device (cuda raises when no CUDA device is present)",
    )

    sp = sub.add_parser("poisson", parents=[common])
    sp.add_argument("--dim", type=int, default=2, choices=[1, 2, 3])
    sp.add_argument("--mg", action="store_true", help="MG-preconditioned CG")

    args = p.parse_args(argv)
    print(json.dumps(_run_poisson(args)))


if __name__ == "__main__":
    main()
