#!/usr/bin/env python3
"""Time the PyTorch port's solve cells and its plane-march Jacobi kernels
from one checkout, for A/B runs of two versions on one card in one call.

    python scripts/ab_cells_torch.py [--root DIR] [--solves 5] [--cells NAME ...]
    python scripts/ab_cells_torch.py --cells jacobi3d jacobi3d_x2   # the kernels alone
    python scripts/ab_cells_torch.py --cells diff_jacobi             # the variable-Γ pass
    python scripts/ab_cells_torch.py --cells axis_stencil axis_stencil5 "QUICK 256^3"
    python scripts/ab_cells_torch.py --cells "dot/ext 512^3"        # the alpha-dot, halo-ext
    python scripts/ab_cells_torch.py --cells "cavity 128^3" "2D-2 441x83" "TGV 64^3" [--fused]
    python scripts/ab_cells_torch.py --cells conv_component advect_pair "Burgers 257^3" \
        "Upwind 256^3"                                                # the advection kernels
    python scripts/ab_cells_torch.py --cells "axis_stencil 2-D" "rz 512x1024" \
        "rz potentials MG" "2D-2 441x83"                              # the 2-D apply's cells

``--root`` is the checkout whose ``pyapes_tpu_torch`` is imported (default:
this one), e.g. a parent commit unpacked with ``git archive`` under
``build/``. Run the versions in turns (parent, change, change, parent) in
one call. The ``placed`` cells place the (4, 2, 1) blocks round robin over
the cards (phase 17's ``placed_devices``; one card: ``("cuda:0",) * 8``). The cells are ``chip_smoke.py``'s (this checkout's file, so both
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
runs them too. The kernel cell ``diff_jacobi`` (the variable-Γ Jacobi
pass) checks it against its plain version at a few shapes (every dtype,
Γ layout, face rule, surgery and mode, the apply too; ``check_vg``) and
times it in bf16 at every level of the Darcy 256^3 and the 512^3
V-cycle (``vg_level_times``: device time per call back to back, the
shape's choice of kernel; where the version has both kernels, each forced
as well). The kernel cells ``axis_stencil`` and ``axis_stencil5`` (the
apply at radius 1 and 2) check it at a few shapes (every dtype, the
radius's equations; ``check_axis``) and time it per call and on the
device at ``axis_level_times``' grids (512^3 down to 64^3 f32, the model's
f64 grids, every 512^3 V-cycle level in bf16; the plane march and the
per-point kernel each forced where the version has both). The kernel
cells ``conv_component`` and ``advect_pair`` (the advection kernels)
check the wrapper at a few shapes (every dtype, surgery kind and the
march's variants; ``check_adv``) and time its path call (Conv central,
Div upwind) per call and on the device at ``adv_level_times``' grids
(512^3 down to 64^3 f32, 256^3 bf16 and f64; the plane march and the
per-point kernel each forced where the version has both). The step cells
``QUICK 256^3``, ``Upwind 256^3`` and ``Burgers 257^3`` step
``chip_smoke.py``'s models (``advdiff_model``, ``burgers_model``)
``--steps`` times through ``_drive_steps`` and report the wall per step
after the first (warm-up) step and ``itr`` per solve.
The flow cells ``cavity 128^3``, ``2D-2 441x83`` and ``TGV 64^3`` step
``chip_smoke.py``'s cavity (``cavity_model``, f32), Schäfer–Turek 2D-2
(``SchaferTurek``, f64) and TGV-3D LES (``tgv_model``, f32) models
eagerly: 2 warm steps, then ``--reps`` chunks of ``--chunk`` steps (host
clock ending in a synchronize); per cell the wall and the process's CPU
time per step of each chunk, their medians, ``itr`` per solve, and of
one more step the host's CUDA API calls (``_api_calls``) and host syncs
(``_count_syncs``), which the host's load does not move. ``--fused`` steps
them through the model's fused runner instead (the bootstrap through
``run(fused=True)``, then one graph replay per step; a version without it
raises), ``itr`` then the last step's.
The kernel cell ``axis_stencil 2-D`` times the 2-D apply at the rz cell
(512 x 1024 f32) and the 2D-2 grid (441 x 83 f64), per call and on the
device, beside the CSR product and a device copy (``axis_2d_times``; where
the version has the row march, the per-point kernel forced and the row
march at several row chunks too, and both kernels on the device at
``ROW_LEVELS``' 2-D grids: ``row_level_times``). The cell ``rz 512x1024`` runs bench's rz
cell (``RzCell``: the potentials, then 5 implicit RFP steps): one warm run,
then ``--reps`` timed runs, wall and CPU time per run and ``itr``; ``rz
potentials MG`` solves its potentials under ``RZ_SHARED`` (BiCGSTAB with
the rz V-cycle, 4,266 ``axis_stencil`` launches) as many times.
The cell ``dot/ext 512^3`` times the axis stencil's alpha-dot at 512^3,
256^3 and 128^3 f32 and its halo-extended apply on the 8 blocks of those
grids in ``N_DECOMP`` (8 launches) in f32 and bf16, per call and on the
device (``dot_ext_level_times``; the plane march and the per-point kernel
each forced where the version has both), and reports the ptxas registers
of the root's axis-stencil entries when this process built its library (a
fresh ``build/``; else an empty list).
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
    # placed round robin over the cards (phase 17 (a) and (f)'s configurations)
    "MG-PCG 512^3 (4, 2, 1) placed": lambda cs: (cs.N_MAIN, {**{
        k: v for k, v in cs.mg_cfg(cs.BENCH_MG).items() if k != "donate"},
        "decomp": _decomp(cs, placed=True)}),
    "Darcy 256^3 (4, 2, 1) placed": lambda cs: (cs.N_DARCY, {**cs.darcy_cfg(),
                                                             "decomp": _decomp(cs, placed=True)}),
}
KERNEL_CELLS = ("jacobi3d", "jacobi3d_x2", "diff_jacobi", "axis_stencil", "axis_stencil5",
                "conv_component", "advect_pair")
RZ_CELLS = ("rz 512x1024", "rz potentials MG")
VG_CHECK_SHAPES = [(1, 65, 33, 129), (2, 70, 19, 131), (1, 4, 4, 4), (1, 65, 130)]
AXIS_CHECK_SHAPES = [(1, 65, 33, 129), (2, 70, 19, 131), (3, 3, 9, 11), (1, 128, 128, 128)]
ADV_CHECK_SHAPES = [(1, 65, 33, 129), (3, 3, 9, 11), (3, 9, 16, 128), (1, 128, 128, 128)]
# name -> chip_smoke's model set-up: (stepper, steps, kernels, label)
STEP_CELLS = {
    "QUICK 256^3": lambda cs, dev: cs.advdiff_model(dev, "quick"),
    "Upwind 256^3": lambda cs, dev: cs.advdiff_model(dev, "upwind"),
    "Burgers 257^3": lambda cs, dev: cs.burgers_model(dev),
}

# name -> (model, dt) of chip_smoke's flow cells, stepped eagerly
FLOW_CELLS = {
    "cavity 128^3": lambda cs, dev: (lambda st: (st.model, st.dt))(cs.cavity_model(dev, 128)[0]),
    "2D-2 441x83": lambda cs, dev: (lambda c: (c.model, c.dt))(cs.SchaferTurek(dev, cs.ST_NY)),
    "TGV 64^3": lambda cs, dev: cs.tgv_model(dev, cs.TGV_N),
}


def _flow_cell(cs, label, dev, chunk: int, reps: int, fused: bool = False) -> dict:
    """Eager or fused steps of a flow cell (module docstring)."""
    import statistics
    import time
    import warnings

    import torch

    model, dt = FLOW_CELLS[label](cs, dev)
    reports = cs._record_solves(model)
    if fused:
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # a fallback to eager steps fails the cell
            model.run(dt, 2, fused=True)
        runner = model.fused_runner()
        step = lambda: runner.step(dt)  # noqa: E731
    else:
        model.run(dt, 2)
        step = lambda: model.step(dt)  # noqa: E731
    torch.cuda.synchronize()
    n0 = len(reports)
    walls, cpus = [], []
    for _ in range(reps):
        c0, tic = time.process_time(), time.perf_counter()
        for _ in range(chunk):
            step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - tic) / chunk)
        cpus.append((time.process_time() - c0) / chunk)
    itr = ([int(r["itr"]) for r in runner.reports] if fused
           else [int(r["itr"]) for r in reports[n0:]])
    return {"fused": fused, "wall_s_per_step": walls, "wall_s_median": statistics.median(walls),
            "cpu_s_per_step": cpus, "cpu_s_median": statistics.median(cpus), "itr": itr,
            "cuda_api_calls_per_step": cs._api_calls(step),
            "host_syncs_per_step": cs._count_syncs(step)}


def _rz_cell(cs, label, dev, reps: int) -> dict:
    """Runs of bench's rz cell or solves of its potentials under
    ``RZ_SHARED`` (module docstring)."""
    import statistics
    import time

    import torch

    if label == "rz 512x1024":
        rz = cs.RzCell(dev, *cs.RZ_CELL)

        def run():
            rz.reset()
            rz.step()
            return [int(r["itr"]) for r in rz.reports]
    else:
        from pyapes_tpu_torch.models import RosenbluthPotentials

        mesh = cs.rz_mesh(dev, *cs.RZ_CELL)
        f0 = cs._rz_f0(mesh)
        pots = RosenbluthPotentials(mesh, f0, cs.RZ_SHARED)

        def run():
            pots.solve(f0)
            return [int(r["itr"]) for r in pots.reports]
    run()  # warm-up
    walls, cpus, itr = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        c0, tic = time.process_time(), time.perf_counter()
        itr.append(run())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - tic)
        cpus.append(time.process_time() - c0)
    return {"wall_s": walls, "wall_s_median": statistics.median(walls), "cpu_s": cpus,
            "cpu_s_median": statistics.median(cpus), "itr": itr}


def _dot_ext_times(cs, dev) -> dict:
    """``chip_smoke.py``'s ``dot_ext_level_times``: ``axis_stencil_dot`` at
    512^3, 256^3 and 128^3 f32 and ``axis_stencil_ext`` on the (4, 2, 1)
    blocks of those grids in f32 and bf16 (one launch per block into its view
    of the result), per call and on the device, both kernels forced where
    the version has both; and the ptxas registers of the root's
    axis-stencil entries."""
    from pyapes_tpu_torch.ops import axis_stencil, cuda_build

    regs = cs._entry_registers(cuda_build.build("axis_stencil").log)
    return {"levels": cs.dot_ext_level_times(dev,
                                             forced=hasattr(axis_stencil, "uses_march_ext")),
            "registers": [[k, r, sp] for k, r, sp in regs]}


def _decomp(cs, placed: bool = False):
    from math import prod

    from pyapes_tpu_torch.parallel import DomainDecomposition

    devices = cs.placed_devices(prod(cs.N_DECOMP)) if placed else None
    return DomainDecomposition(cs.N_DECOMP, devices=devices)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=HERE)
    p.add_argument("--solves", type=int, default=5)
    p.add_argument("--steps", type=int, default=4, help="steps of a step cell (the first warms up)")
    p.add_argument("--chunk", type=int, default=10, help="steps per timed chunk of a flow cell")
    p.add_argument("--reps", type=int, default=3, help="timed chunks of a flow cell, runs of an rz cell")
    p.add_argument("--fused", action="store_true", help="flow cells through the fused runner")
    p.add_argument("--cells", nargs="+",
                   choices=[*CELLS, *KERNEL_CELLS, *STEP_CELLS, *FLOW_CELLS, *RZ_CELLS,
                            "dot/ext 512^3", "axis_stencil 2-D"],
                   default=[*CELLS, *KERNEL_CELLS, *STEP_CELLS, "dot/ext 512^3"])
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
        if label == "diff_jacobi":
            from pyapes_tpu_torch.ops import diff_field

            _, worst = cs.check_vg(dev, VG_CHECK_SHAPES, forced=False)
            out["cells"][label] = {"worst_err_over_limit": worst["choice"],
                                   "levels": cs.vg_level_times(
                                       dev, forced=hasattr(diff_field, "uses_march"))}
            continue
        if label in ("axis_stencil", "axis_stencil5"):
            from pyapes_tpu_torch.ops import axis_stencil

            radii = (1,) if label == "axis_stencil" else (2,)
            _, worst = cs.check_axis(dev, AXIS_CHECK_SHAPES, forced=False, radii=radii)
            out["cells"][label] = {"worst_err_over_limit": worst["choice"],
                                   "levels": cs.axis_level_times(
                                       dev, forced=hasattr(axis_stencil, "uses_march"),
                                       radii=radii)}
            continue
        if label in ("conv_component", "advect_pair"):
            from pyapes_tpu_torch.ops import advect

            _, worst = cs.check_adv(dev, ADV_CHECK_SHAPES, forced=False, names=(label,))
            out["cells"][label] = {"worst_err_over_limit": worst["choice"],
                                   "levels": cs.adv_level_times(
                                       dev, forced=hasattr(advect, "uses_march"), names=(label,))}
            continue
        if label == "axis_stencil 2-D":
            from pyapes_tpu_torch.ops import axis_stencil

            forced = hasattr(axis_stencil, "uses_row_march")
            out["cells"][label] = {"rows": cs.axis_2d_times(dev, forced=forced),
                                   "levels": cs.row_level_times(dev) if forced else []}
            continue
        if label in RZ_CELLS:
            out["cells"][label] = _rz_cell(cs, label, dev, args.reps)
            continue
        if label == "dot/ext 512^3":
            out["cells"][label] = _dot_ext_times(cs, dev)
            continue
        if label in FLOW_CELLS:
            out["cells"][label] = _flow_cell(cs, label, dev, args.chunk, args.reps, args.fused)
            continue
        if label in STEP_CELLS:
            stepper, _, _, name = STEP_CELLS[label](cs, dev)
            stats = cs._drive_steps(stepper, stepper.model.solver, args.steps, name, ())
            out["cells"][label] = {"wall_s": stats["wall_s"][1:],
                                   "wall_s_median": stats["wall_s_per_step_median"],
                                   "itr": stats["itr"]}
            del stepper
            continue
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
