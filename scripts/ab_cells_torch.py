#!/usr/bin/env python3
"""Time the PyTorch port's solve cells and its plane-march Jacobi kernels
from one checkout, for A/B runs of two versions on one card in one call.

    python scripts/ab_cells_torch.py [--root DIR] [--solves 5] [--cells NAME ...]
    python scripts/ab_cells_torch.py --cells jacobi3d jacobi3d_x2   # the kernels alone

``--root`` is the checkout whose ``pyapes_tpu_torch`` is imported (default:
this one), e.g. a parent commit unpacked with ``git archive`` under
``build/``. Run the versions in turns (parent, change, change, parent) in
one call. The cells are ``chip_smoke.py``'s (this checkout's file, so both
versions get the same traffic): its problem (3-D f32 all-Dirichlet random
RHS, tol 1e-6) through ``fd_cfg`` / ``mg_cfg`` and ``_solve_path``. Per
cell: one warm-up, then ``--solves`` timed solves (host clock ending in a
synchronize). Prints one JSON line with the root, the card, and per cell
the walls, their median, the process's CPU time per solve (``cpu_s``: a
host-bound cell's wall follows it) and ``itr``. The kernel cells
``jacobi3d`` (the single sweep and its dot) and ``jacobi3d_x2`` (the
double sweep) check the kernel against its plain version at
``chip_smoke.py``'s check shapes (every dtype and variant; ``check_march``)
and time it in bf16 at every level shape of the 512^3 V-cycle
(``level_times``: per call and on the device, GB/s, share of the bound),
through the wrappers' common signature only, so that an older ``--root``
runs them too.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (grid edge, solver config) from chip_smoke's definitions
CELLS = {
    "fastdiag 512^3": lambda cs: (cs.N_MAIN, cs.fd_cfg()),
    "fastdiag 512^3 (4, 2, 1)": lambda cs: (cs.N_MAIN, cs.fd_cfg(_decomp(cs))),
    "MG-PCG 512^3": lambda cs: (cs.N_MAIN, cs.mg_cfg(cs.BENCH_MG)),
    "MG-PCG 512^3 (4, 2, 1)": lambda cs: (cs.N_MAIN, cs.mg_cfg(cs.BENCH_MG, _decomp(cs))),
    "MG-PCG 256^3 V(1,1)": lambda cs: (cs.N_V11, cs.mg_cfg(cs.V11_MG)),
    "Darcy 256^3": lambda cs: (cs.N_DARCY, cs.darcy_cfg()),
}
KERNEL_CELLS = ("jacobi3d", "jacobi3d_x2")


def _decomp(cs):
    from pyapes_tpu_torch.parallel import DomainDecomposition

    return DomainDecomposition(cs.N_DECOMP)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=HERE)
    p.add_argument("--solves", type=int, default=5)
    p.add_argument("--cells", nargs="+", choices=[*CELLS, *KERNEL_CELLS],
                   default=[*CELLS, *KERNEL_CELLS])
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs._counts = dict  # an A/B reads walls; the other version may lack a wrapper

    import torch

    from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache

    if not torch.cuda.is_available():
        raise RuntimeError("ab_cells_torch: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = {"root": args.root, "card": card, "cells": {}}
    dev = torch.device("cuda")
    for label in args.cells:
        clear_cache()
        if label in KERNEL_CELLS:  # only the wrapper's common signature: --root may be older
            worst, _ = cs.check_march(dev, label, chunks=False)
            out["cells"][label] = {"worst_err_over_limit": worst,
                                   "levels": cs.level_times(dev, label)}
            continue
        n, cfg = CELLS[label](cs)
        stats, _ = cs._solve_path(dev, n, cfg, label, darcy=label.startswith("Darcy"),
                                  solves=args.solves)
        out["cells"][label] = {k: stats[k] for k in ("wall_s", "wall_s_median", "cpu_s", "itr")}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
