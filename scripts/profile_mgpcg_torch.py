#!/usr/bin/env python3
"""Profile one steady MG-PCG solve of the PyTorch port on an NVIDIA GPU
(or one step of the 3-D Burgers model).

    python scripts/profile_mgpcg_torch.py [--n 512] [--out chiprun_out/profile_mgpcg]
    python scripts/profile_mgpcg_torch.py --darcy [--n 256] [--out ...]
    python scripts/profile_mgpcg_torch.py --burgers [--n 256] [--out ...]
    python scripts/profile_mgpcg_torch.py --decomp 4,2,1 [--fastdiag] [--out ...]

The problem is ``chip_smoke.py``'s MG-PCG path (``bench.py``'s cg config:
3-D f32 all-Dirichlet random RHS, tol 1e-6, bf16 V(2,2), FMG, fused r.z),
or with ``--darcy`` its variable-Γ path (``bench.py``'s ``bench_darcy``:
Γ = exp(0.8 sin 2πx sin 2πy sin 2πz), the same cycle without the fused
r.z, max_it 400), or with ``--burgers`` one step of ``chip_smoke.py``'s
``BurgersND`` path ((n+1)^3 f32 periodic box, Taylor-Green start, dt 0.01:
three BiCGSTAB solves with the FD preconditioner through the convection
kernel). ``--decomp 4,2,1`` solves the Poisson problem with that
``DomainDecomposition`` (the block-wise applies through the halo-extended
kernel), and ``--fastdiag`` takes ``chip_smoke.py``'s fastdiag path
instead of MG-PCG.
After one warm-up solve (step), ``torch.profiler`` records one; the script
prints (and writes to ``<out>/summary.json``, next to the Chrome trace):

- kernel rows: device time by kernel name from the trace's kernel,
  memcpy and memset events, and grouped (the port's Hopper kernels,
  transfer GEMMs, elementwise, reductions, copies); each Hopper kernel
  also by its launch grid, which names the MG level it ran on;
- the device's busy time as the UNION of the kernel/memcpy/memset
  intervals of the trace inside the host range of ``Solver.solve``, and
  the idle share ``1 - busy / range``;
- the host's stream synchronizations, copies and kernel launches in that
  range;
- the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("axis_stencil_ext (Hopper)", ("axis_stencil_ext_kernel",)),
    ("diff_jacobi (Hopper)", ("diff_jacobi_kernel",)),
    ("diff_field (Hopper)", ("diff_field_kernel",)),
    ("advect_pair / conv_component (Hopper)", ("advect_kernel",)),
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
                   help="grid size (512, or 256 with --darcy / --burgers)")
    p.add_argument("--darcy", action="store_true", help="the variable-Γ path")
    p.add_argument("--burgers", action="store_true", help="one step of the 3-D Burgers model")
    p.add_argument("--decomp", default=None,
                   help="blocks per axis, e.g. 4,2,1: a decomposed Poisson solve")
    p.add_argument("--fastdiag", action="store_true", help="the fastdiag Poisson solve")
    p.add_argument("--out", default="chiprun_out/profile_mgpcg")
    args = p.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import BurgersND
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
    n = args.n or (256 if args.darcy or args.burgers else 512)
    if args.burgers:
        mesh = Mesh(Box[0:2 * torch.pi, 0:2 * torch.pi, 0:2 * torch.pi], None, [n + 1] * 3,
                    device="cuda", dtype="single")
        X, Y, Z = mesh.X, mesh.Y, mesh.Z
        model = BurgersND(mesh, nu=0.1, init_vals=[
            (torch.sin(X) * torch.cos(Y) * torch.cos(Z))[None],
            (-torch.cos(X) * torch.sin(Y) * torch.cos(Z))[None], torch.zeros((1, *mesh.nx))])

        def prepare():
            pass

        def run():
            model.step(0.01)
            return model.report
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
            cfg["decomp"] = DomainDecomposition(tuple(int(m) for m in args.decomp.split(",")))
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
    by_grid = defaultdict(lambda: [0, 0.0])  # (Hopper group, grid) -> [calls, device ms]
    for e in dev:
        if "(Hopper)" in _group(e["name"]):
            g = by_grid[(_group(e["name"]), str(e.get("args", {}).get("grid")))]
            g[0] += 1
            g[1] += e["dur"] / 1e3
    groups = defaultdict(lambda: [0, 0.0])
    for name, (cnt, ms) in rows.items():
        g = groups[_group(name)]
        g[0] += cnt
        g[1] += ms
    summary = {
        "card": smi, "case": "burgers" if args.burgers else "darcy" if args.darcy else "poisson",
        "method": "fastdiag" if args.fastdiag else "mg-pcg", "decomp": args.decomp,
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
        "groups": {k: {"calls": c, "device_ms": ms, "share_of_range": ms / range_ms}
                   for k, (c, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1])},
        "hopper_kernels_by_grid": [
            {"group": k[0], "grid": k[1], "calls": c, "device_ms": ms}
            for k, (c, ms) in sorted(by_grid.items(), key=lambda kv: -kv[1][1])],
        "top_kernels": [{"name": k[:120], "calls": c, "device_ms": ms}
                        for k, (c, ms) in sorted(rows.items(), key=lambda kv: -kv[1][1])[:25]],
    }
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
