#!/usr/bin/env python3
"""A domain-decomposed Poisson solve through the PyTorch port (the port of
``demos/sharded_poisson.py``): the same MG-PCG solve undecomposed and in
blocks, the decomposition ONE config entry. Each decomposition runs twice:
as views of one tensor on the solve's device, and placed, each block its
own allocation on its device, round robin over every card the machine
shows with ``--device cuda`` (as the JAX demo uses every device
``jax.devices()`` shows; on the CPU every block on the CPU). The stencil's
neighbour reads become halo copies (of the ghost faces alone when placed)
and each block is its own launch of the halo-extended kernel on its card.

    python scripts/sharded_poisson_torch.py [--device cuda] [--json]

The demo's set-up: 32^3 f32 nodes, homogeneous Dirichlet, a random RHS
(seed 0), CG with the multigrid preconditioner at tol 1e-8 (residual
criterion, max_it 2000), single and in the (2, 2, 2) and (8, 1, 1)
decompositions; the demo's gate: max|x_decomposed - x_single| < 1e-8. On
the card, its name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

DECOMPS = ((2, 2, 2), (8, 1, 1))


def solve(n: int, device: str, decomp=None):
    """The demo's solve; returns the solution, the report and the wall (s)."""
    import numpy as np
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.utils.profile import SolveTimer
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n, n, n], device=device, dtype="single")
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet"), "obstacle": None},
                init_val=0.0)
    rng = np.random.default_rng(0)
    rhs = torch.as_tensor(rng.standard_normal((1, n, n, n)), dtype=torch.float32,
                          device=mesh.device)
    cfg = {"method": "cg", "tol": 1e-8, "max_it": 2000, "report": False,
           "criterion": "residual", "precond": "mg"}
    if decomp is not None:
        cfg["decomp"] = decomp
    solver = Solver({"fdm": cfg})
    solver.set_eq(FDM().laplacian(1.0, var) == rhs)
    with SolveTimer() as t:
        rep = solver.solve()
    return var()[0], rep, t.elapsed


def placed_devices(device: str, shape) -> tuple:
    """One device per block: round robin over every card the machine shows
    (``device`` "cuda"), else ``device`` for every block."""
    import numpy as np
    import torch

    n = int(np.prod(shape))
    if str(device).startswith("cuda"):
        k = torch.cuda.device_count()
        return tuple(f"cuda:{i % k}" for i in range(n))
    return (device,) * n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="decomposed Poisson (port of "
                                             "demos/sharded_poisson.py)")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true", help="print one JSON line at the end")
    args = ap.parse_args(argv)

    from pyapes_tpu_torch.parallel import DomainDecomposition
    from pyapes_tpu_torch.testing.demo import card, finish

    gpu = card(args.device)
    ref, rep0, wall0 = solve(args.n, args.device)
    print(f"single        : itr={rep0['itr']} tol={rep0['tol']:.2e} wall {wall0:.3f}s")
    rows, gate = [], {}
    for shape in DECOMPS:
        for layout, devs in (("views", None), ("placed", placed_devices(args.device, shape))):
            dd = DomainDecomposition(shape, devices=devs)
            x, rep, wall = solve(args.n, args.device, dd)
            err = (x - ref).abs().max().item()
            print(f"decomp {shape} {layout:6s}: itr={rep['itr']} tol={rep['tol']:.2e} "
                  f"max|diff vs single|={err:.2e} wall {wall:.3f}s", flush=True)
            rows.append({"decomp": list(shape), "layout": layout,
                         "devices": None if devs is None else [str(d) for d in dd.devices],
                         "itr": rep["itr"], "tol": rep["tol"], "max_abs_diff": err,
                         "wall_s": wall})
            gate[f"{shape} {layout}: max|diff vs single| < 1e-8"] = err < 1e-8
    out = {"demo": "sharded_poisson", "n": args.n, "dtype": "single",
           "single": {"itr": rep0["itr"], "tol": rep0["tol"], "wall_s": wall0},
           "decomposed": rows, "card": gpu, "gate": gate}
    return finish("sharded_poisson", out, args.json)


if __name__ == "__main__":
    main()
