#!/usr/bin/env python3
"""Profile one steady MG-PCG solve of the PyTorch port on an NVIDIA GPU
(or one step of the 3-D Burgers, the QUICK or upwind advection-diffusion
model, the lid-driven cavity, the rz/RFP cell, the Schäfer–Turek 2D-2
channel or the 3-D Taylor-Green LES).

    python scripts/profile_mgpcg_torch.py [--n 512] [--out chiprun_out/profile_mgpcg]
    python scripts/profile_mgpcg_torch.py --darcy [--n 256] [--out ...]
    python scripts/profile_mgpcg_torch.py --burgers [--n 256] [--out ...]
    python scripts/profile_mgpcg_torch.py --quick [--n 256] [--out ...]
    python scripts/profile_mgpcg_torch.py --upwind [--n 256] [--out ...]
    python scripts/profile_mgpcg_torch.py --cavity [--implicit] [--n 128] [--out ...]
    python scripts/profile_mgpcg_torch.py --rfp [--n 512] [--out ...]
    python scripts/profile_mgpcg_torch.py --channel [--n 83] [--out ...]
    python scripts/profile_mgpcg_torch.py --periodic [--n 64] [--out ...]
    python scripts/profile_mgpcg_torch.py --decomp 4,2,1 [--placed] [--fastdiag] [--out ...]
    python scripts/profile_mgpcg_torch.py --root build/parent --quick [--out ...]

The problem is ``chip_smoke.py``'s MG-PCG path (``bench.py``'s cg config:
3-D f32 all-Dirichlet random RHS, tol 1e-6, bf16 V(2,2), FMG, fused r.z),
or with ``--darcy`` its variable-Γ path (``bench.py``'s ``bench_darcy``:
Γ = exp(0.8 sin 2πx sin 2πy sin 2πz), the same cycle without the fused
r.z, max_it 400), or with ``--burgers`` one step of ``chip_smoke.py``'s
``BurgersND`` path (``burgers_model``: (n+1)^3 f32 periodic box,
Taylor-Green start, dt 0.01: three BiCGSTAB solves with the FD
preconditioner through the convection kernel), or with ``--quick`` one
step of its QUICK ``AdvectionDiffusion`` path (``advdiff_model``: n^3 f32,
constant velocity, dt 1e-3: one unpreconditioned BiCGSTAB solve through
the 5-point axis stencil), or with ``--upwind`` one step of its
upwind ``AdvectionDiffusion`` path (``advdiff_model``: n^3 f32, the
velocity field 1 + 0.5 sin 2πx sin 2πy sin 2πz, dt 1e-3: one BiCGSTAB
solve with the FD preconditioner through the Div kernel), or with ``--cavity``
one step of its NS cavity cell (``cavity_model``: ``bench.py``'s cavity,
n^3 f32, Re 100, regularized lid, dt 0.25/n: three fastdiag momentum
solves, the fastdiag pressure solve and the explicit FDC glue between
them; ``--implicit``: the momentum by BiCGSTAB with the FD preconditioner
through the convection kernel) after two warm steps, or with ``--rfp``
one run of its rz/RFP cell (``bench.py``'s ``bench_rz``: a Cylinder[0:4,
-4:4] mesh of n x 2n f32 nodes, the Rosenbluth potentials H and G by
fastdiag, then 5 implicit RFP steps of dt 1e-3 by the FD-preconditioned
BiCGSTAB of ``fdm.custom``) after one warm run, or with ``--channel`` one
step of its Schäfer–Turek 2D-2 cell (``SchaferTurek``: ``ChannelFlow`` past
a cylinder at Re 100, ny = n (83: 441 x 83) f64, two plain BiCGSTAB
momentum solves and the pressure's BiCGSTAB with the plain-domain V-cycle,
with the per-step force diagnostics on the card) after two warm steps, or
with ``--periodic`` one step of its TGV-3D LES cell (``tgv_model``:
``PeriodicFlow`` at n^3 f32, Re 1600, Smagorinsky cs 0.17, dt 0.2 dx:
three plain BiCGSTAB momentum solves through the variable-Γ kernel, the
fastdiag pressure solve, the strain rate, the skew advection and the
projection between them) after two warm steps.
``--decomp 4,2,1`` solves the Poisson problem
with that ``DomainDecomposition`` (the block-wise applies through the
halo-extended kernel; ``--placed``: each block its own allocation, round
robin over the cards the machine shows), and ``--fastdiag`` takes
``chip_smoke.py``'s fastdiag path instead of MG-PCG. ``--root`` is the
checkout whose ``pyapes_tpu_torch`` is profiled (default: this one; e.g. a
parent commit unpacked under ``build/``, for a profile of both versions in
one call); the problems are this checkout's.
After one warm-up solve (step), ``torch.profiler`` records one; the script
prints (and writes to ``<out>/summary.json``, next to the Chrome trace):

- kernel rows: device time by kernel name from the trace's kernel,
  memcpy and memset events, and grouped (the port's Hopper kernels,
  transfer GEMMs, elementwise, reductions, copies); each Hopper kernel
  also by its launch grid, which names the MG level it ran on, and
  kernel with its template arguments (the plane march or the per-point
  kernel; dtype, radius or mode);
- the device's busy time as the UNION of the kernel/memcpy/memset
  intervals of the trace inside the host range of ``Solver.solve``, and
  the idle share ``1 - busy / range``;
- the host's stream synchronizations, copies and kernel launches
  (runtime calls) in that range, and the device kernels it ran;
- the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("axis_stencil / axis_stencil5 plane march (Hopper)", ("axis_march_kernel",)),
    ("axis_stencil_dot plane march (Hopper)", ("axis_march_dot_kernel",)),
    ("axis_stencil_ext plane march (Hopper)", ("axis_march_ext_kernel",)),
    ("axis_stencil_ext (Hopper)", ("axis_stencil_ext_kernel",)),
    ("axis_stencil 2-D row march (Hopper)", ("axis_row_march_kernel",)),
    ("diff_jacobi (Hopper)", ("diff_jacobi_kernel", "diff_jacobi_march_kernel")),
    ("diff_field (Hopper)", ("diff_field_kernel", "diff_field_march_kernel")),
    ("advect_pair / conv_component (Hopper)", ("advect_kernel", "advect_march_kernel")),
    ("axis_stencil5 (Hopper)", ("axis_stencil5_kernel",)),
    ("jacobi3d_x2 (Hopper)", ("jacobi3d_x2_kernel",)),
    ("jacobi3d / jacobi3d_dot (Hopper)", ("jacobi3d_kernel",)),
    ("axis_stencil_dot (Hopper)", ("axis_stencil_dot_kernel",)),
    ("axis_stencil (Hopper)", ("axis_stencil_kernel",)),
    ("GEMMs (cuBLAS: MG transfers, FD eigen-transforms)", ("gemm", "cutlass", "xmma", "nvjet")),
    ("reductions (dots, norms, partial sums)", ("reduce",)),
    ("copies (permute, cast, contiguous)", ("copy", "Memcpy", "memcpy", "cat", "Memset")),
)


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise (axpy, mask, cast)"


def _union_ms(intervals, lo, hi) -> float:
    busy, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy / 1e3


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=None,
                   help="grid size (512, or 256 with --darcy / --burgers / --quick / --upwind)")
    p.add_argument("--darcy", action="store_true", help="the variable-Γ path")
    p.add_argument("--burgers", action="store_true", help="one step of the 3-D Burgers model")
    p.add_argument("--quick", action="store_true",
                   help="one step of the QUICK advection-diffusion model")
    p.add_argument("--upwind", action="store_true",
                   help="one step of the upwind advection-diffusion model (a velocity field)")
    p.add_argument("--cavity", action="store_true", help="one step of the NS cavity")
    p.add_argument("--rfp", action="store_true",
                   help="one run of the rz/RFP cell (potentials + 5 implicit steps)")
    p.add_argument("--channel", action="store_true",
                   help="one step of the Schäfer–Turek 2D-2 channel (ny = --n, default 83)")
    p.add_argument("--periodic", action="store_true",
                   help="one step of the TGV-3D Smagorinsky LES (n^3 nodes, default 64)")
    p.add_argument("--implicit", action="store_true",
                   help="with --cavity: implicit advection (the convection kernel)")
    p.add_argument("--decomp", default=None,
                   help="blocks per axis, e.g. 4,2,1: a decomposed Poisson solve")
    p.add_argument("--fastdiag", action="store_true", help="the fastdiag Poisson solve")
    p.add_argument("--placed", action="store_true",
                   help="with --decomp: the blocks placed round robin over the cards")
    p.add_argument("--fused", action="store_true",
                   help="with --cavity/--channel/--periodic: the bootstrap through "
                        "run(fused=True), then one step of the fused runner (one CUDA graph "
                        "replay, synchronized inside the profiled range)")
    p.add_argument("--out", default="chiprun_out/profile_mgpcg")
    p.add_argument("--root", default=HERE, help="the checkout whose package is profiled")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.parallel import DomainDecomposition
    from pyapes_tpu_torch.solver.fdm import FDM
    from pyapes_tpu_torch.solver.ops import Solver
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    if not torch.cuda.is_available():
        raise RuntimeError("profile_mgpcg_torch: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    os.makedirs(args.out, exist_ok=True)
    step = (args.burgers or args.quick or args.upwind or args.cavity or args.rfp or args.channel
            or args.periodic)
    n = args.n or (128 if args.cavity else 512 if args.rfp else 83 if args.channel
                   else 64 if args.periodic
                   else 256 if args.darcy or step else 512)
    if step:
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      os.path.join(HERE, "chip_smoke.py"))
        chip_smoke = importlib.util.module_from_spec(spec)  # this checkout's, whatever --root
        spec.loader.exec_module(chip_smoke)
        dev = torch.device("cuda")
        if args.fused and (args.cavity or args.channel or args.periodic):
            if args.cavity:
                model, dt = (lambda s: (s.model, s.dt))(chip_smoke.cavity_model(dev, n)[0])
            elif args.periodic:
                model, dt = chip_smoke.tgv_model(dev, n)
            else:
                cell = chip_smoke.SchaferTurek(dev, n)
                model, dt = cell.model, cell.dt
            model.run(dt, 2, fused=True)  # the bootstrap; its second step captures the graph
            runner = model.fused_runner()
            stepper = type("FusedStep", (), {"model": model,
                                             "step": lambda self: runner.step(dt)})()
        elif args.cavity:
            stepper = chip_smoke.cavity_model(dev, n, args.implicit)[0]
            for _ in range(2):  # the cell's warm steps
                stepper.step()
        elif args.rfp:
            stepper = chip_smoke.RzCell(dev, n, 2 * n)
        elif args.periodic:
            stepper = chip_smoke._Stepper(*chip_smoke.tgv_model(dev, n))
            for _ in range(2):  # the cell's warm steps
                stepper.step()
        elif args.channel:
            cell = chip_smoke.SchaferTurek(dev, n)
            cell.run(2)  # the cell's warm steps
            diags = []
            stepper = type("ChannelStep", (), {"model": cell.model,
                                               "step": lambda self: cell.run(1, diags)})()
        else:
            stepper = (chip_smoke.burgers_model(dev, n) if args.burgers
                       else chip_smoke.advdiff_model(dev, "quick" if args.quick else "upwind",
                                                     n))[0]

        def prepare():
            if args.rfp:
                stepper.reset()

        def run():
            stepper.step()
            if args.fused:  # the pressure solve's device scalars, synchronized in the range
                rep = stepper.model._fused.reports[-1]
                return {"itr": int(rep["itr"]), "tol": float(rep["tol"])}
            if args.cavity or args.channel or args.periodic:  # the last solve: the pressure
                return stepper.model.p_solver.report
            return stepper.model.report  # --rfp: the last implicit step's
    else:
        mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device="cuda", dtype="single")
        var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet")},
                    init_val=0.0)
        rhs = torch.randn((1, n, n, n), generator=torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
        coeff = 1.0
        if args.darcy:
            coeff = torch.exp(0.8 * torch.sin(2 * torch.pi * mesh.X)
                              * torch.sin(2 * torch.pi * mesh.Y)
                              * torch.sin(2 * torch.pi * mesh.Z)).contiguous()
        cfg = {"method": "cg", "precond": "mg", "tol": 1e-6,
               "max_it": 400 if args.darcy else 200, "criterion": "residual",
               "mg_opts": {"dtype": "bfloat16", "n_pre": 2, "n_post": 2, "omega": 0.857,
                           "fmg": True, "fuse_rz": not args.darcy}}
        if args.fastdiag:
            cfg = {"method": "fastdiag", "tol": 1e-6, "max_it": 4000, "criterion": "residual"}
        if args.decomp:
            ms = tuple(int(m) for m in args.decomp.split(","))
            k = torch.cuda.device_count()
            devs = (tuple(f"cuda:{i % k}" for i in range(math.prod(ms))) if args.placed
                    else None)
            cfg["decomp"] = DomainDecomposition(ms, devices=devs)
        solver = Solver({"fdm": cfg})
        fdm = FDM()

        def prepare():
            var.set_var_tensor(torch.zeros_like(var()))
            solver.set_eq(fdm.laplacian(coeff, var) == rhs)

        def run():
            return solver.solve()

    def one_solve(annotate=False):
        prepare()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        if annotate:
            with record_function("mgpcg_solve"):
                rep = run()
        else:
            rep = run()
        torch.cuda.synchronize()
        return rep, time.perf_counter() - tic

    one_solve()  # warm-up: builds the kernels and the MG hierarchy
    _, wall = one_solve()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rep, wall_prof = one_solve(annotate=True)
    trace = os.path.join(args.out, "trace.json")
    prof.export_chrome_trace(trace)

    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    rng = [e for e in events if e.get("name") == "mgpcg_solve" and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]  # the host range of the solve
    lo, hi = rng[0]["ts"], rng[0]["ts"] + rng[0]["dur"]
    dev = [e for e in events if e.get("ph") == "X" and lo <= e["ts"] <= hi
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy_ms = _union_ms([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi)
    runtime = [e["name"] for e in events if e.get("ph") == "X"
               and e.get("cat") == "cuda_runtime" and lo <= e["ts"] <= hi]
    range_ms = (hi - lo) / 1e3
    rows = defaultdict(lambda: [0, 0.0])  # kernel name -> [calls, device ms]
    for e in dev:
        rows[e["name"]][0] += 1
        rows[e["name"]][1] += e["dur"] / 1e3
    by_grid = defaultdict(lambda: [0, 0.0])  # (Hopper group, grid, kernel) -> [calls, device ms]
    for e in dev:
        if "(Hopper)" in _group(e["name"]):
            kernel = re.search(r"(\w+_kernel(?:<[^>]*>)?)", e["name"])
            g = by_grid[(_group(e["name"]), str(e.get("args", {}).get("grid")),
                         kernel.group(1) if kernel else e["name"][:60])]
            g[0] += 1
            g[1] += e["dur"] / 1e3
    groups = defaultdict(lambda: [0, 0.0])
    for name, (cnt, ms) in rows.items():
        g = groups[_group(name)]
        g[0] += cnt
        g[1] += ms
    summary = {
        "card": smi, "root": args.root,
        "case": ("burgers" if args.burgers else "quick" if args.quick else "upwind" if args.upwind
                 else ("cavity implicit" if args.implicit else "cavity") if args.cavity
                 else "rfp" if args.rfp else "channel (2D-2)" if args.channel
                 else "TGV-3D LES" if args.periodic
                 else "darcy" if args.darcy else "poisson"),
        "method": ("fused model step" if args.fused else "model step" if step
                   else "fastdiag" if args.fastdiag else "mg-pcg"), "decomp": args.decomp,
        "placed": args.placed,
        "n": n, "itr": rep["itr"],
        "tol": rep["tol"],
        "wall_unprofiled_ms": wall * 1e3, "wall_profiled_ms": wall_prof * 1e3,
        "range_ms": range_ms, "device_busy_union_ms": busy_ms,
        "device_kernel_sum_ms": sum(ms for _, ms in rows.values()),
        "idle_share": 1.0 - busy_ms / range_ms,
        # host waits inside Solver.solve: the per-iteration tolerance read
        # plus the set-up uploads of the coefficient vectors
        "stream_syncs": sum(n == "cudaStreamSynchronize" for n in runtime),
        "memcpy_calls": sum(n.startswith("cudaMemcpy") for n in runtime),
        "kernel_launches": sum(n.startswith("cudaLaunchKernel") for n in runtime),
        "device_kernels": sum(e.get("cat") == "kernel" for e in dev),
        "groups": {k: {"calls": c, "device_ms": ms, "share_of_range": ms / range_ms}
                   for k, (c, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1])},
        "hopper_kernels_by_grid": [
            {"group": k[0], "grid": k[1], "kernel": k[2], "calls": c, "device_ms": ms}
            for k, (c, ms) in sorted(by_grid.items(), key=lambda kv: -kv[1][1])],
        "top_kernels": [{"name": k[:120], "calls": c, "device_ms": ms}
                        for k, (c, ms) in sorted(rows.items(), key=lambda kv: -kv[1][1])[:25]],
    }
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
