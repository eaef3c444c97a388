#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, report lines before the last:

1. device — require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them; check TF32 is off for float32 matmuls.
2. build  — compile every Hopper kernel source of ``pyapes_tpu_torch/csrc``
   (one ``nvcc`` each, started together); print ptxas registers/spills.
3. kernel — each kernel against its plain PyTorch version on the card
   (axis stencil: five shapes; stencil alpha-dot and the Jacobi family:
   five shapes x f32/bf16/f64 x their variants, dots included), and kernel
   vs plain timed at 512^3 (CUDA events).
4. fastdiag path — the 512^3 f32 all-Dirichlet random-RHS Poisson solve
   through ``Solver.solve`` (fastdiag), as ``bench.py`` drives the JAX
   package: one warm-up and three timed solves; convergence, kernel
   launches per solve, and the true residual recomputed independently.
5. MG-PCG path — the same problem through ``bench.py``'s cg config (bf16
   V(2,2), FMG, fused r.z) at 512^3, and a V(1,1) fused-r.z config at
   256^3 (where the Jacobi + dot kernel runs): the same checks, each
   kernel's launches per solve, the true residual in f32 and f64.
6. model — ``PoissonSolver`` on the runner's 3-D problem at 65^3 and 129^3
   (f64): convergence, and the error against the exact solution equal to
   the predicted discretization error.

Every kernel launch count is set to 0 just before each path (phases 4-6)
and read just after; a kernel of a path that launched no time there fails
the run. Then one JSON line of per-kernel numbers, and as the LAST line
``{"ok": true, "device": {...}}``. Any failure is an uncaught exception and
a non-zero exit, with no result line.
"""
from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import time
from math import pi, sin

N_MAIN = 512
N_V11 = 256
KERNEL_SHAPES = [  # (shape incl. vdim, dtype name) of the axis stencil
    ((1, 512, 512, 512), "float32"),
    ((3, 64, 64, 64), "float32"),
    ((1, 65, 33, 129), "float32"),
    ((1, 1025, 1025), "float32"),
    ((1, 33, 34, 35), "float64"),
]
# the stencil alpha-dot and the Jacobi family: 3-D shapes, down to tiny
# MG levels, in the three storage dtypes
KERNEL3D_SHAPES = [(1, 512, 512, 512), (3, 64, 64, 64), (1, 65, 33, 129), (1, 4, 4, 4),
                   (1, 5, 9, 17)]
DTYPES = ["float32", "bfloat16", "float64"]
# kernel and plain sum the same products in another order (the kernel may
# fuse multiply-adds) in promote(dtype, f32): f32 1e-5 of the output's
# scale, f64 1e-12; bf16 rounds the output once and an f32 difference at a
# rounding boundary moves it by one bf16 ulp (2^-8): 1e-2. Dots are f32
# (f64) sums held to 1e-5 (1e-12) of sum|products|.
REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float64": 1e-12}
DOT_TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float64": 1e-12}
# (name, module, source, the TPU function it replaces)
KERNELS = [
    ("axis_stencil", "pyapes_tpu_torch.ops.axis_stencil",
     "pyapes_tpu_torch/csrc/axis_stencil.cu", "pyapes_tpu/ops/pallas_stencil.py:323"),
    ("axis_stencil_dot", "pyapes_tpu_torch.ops.axis_stencil",
     "pyapes_tpu_torch/csrc/axis_stencil.cu", "pyapes_tpu/ops/pallas_stencil_db.py:248"),
    ("jacobi3d", "pyapes_tpu_torch.ops.jacobi",
     "pyapes_tpu_torch/csrc/jacobi3d.cu", "pyapes_tpu/ops/pallas_stencil.py:551"),
    ("jacobi3d_dot", "pyapes_tpu_torch.ops.jacobi",
     "pyapes_tpu_torch/csrc/jacobi3d.cu", "pyapes_tpu/ops/pallas_stencil_db.py:570"),
    ("jacobi3d_x2", "pyapes_tpu_torch.ops.jacobi",
     "pyapes_tpu_torch/csrc/jacobi3d.cu", "pyapes_tpu/ops/pallas_stencil_v3.py:881"),
]
# bench.py's PYAPES_BENCH_METHOD=cg configuration
BENCH_MG = {"dtype": "bfloat16", "n_pre": 2, "n_post": 2, "omega": 0.857, "fmg": True,
            "fuse_rz": True}
V11_MG = {**BENCH_MG, "n_pre": 1, "n_post": 1}


def _wrappers() -> dict:
    return {name: getattr(importlib.import_module(mod), name) for name, mod, _, _ in KERNELS}


def _reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    from pyapes_tpu_torch.backend import Device

    dev = Device("cuda").device
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("chip_smoke: TF32 is on")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("chip_smoke: float32 matmul precision is not 'highest'")
    print(smi, flush=True)
    print(
        f"[1 device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} tf32=off",
        flush=True,
    )
    return dev, smi


def phase_build():
    from pyapes_tpu_torch.ops import cuda_build

    tic = time.perf_counter()
    builds = cuda_build.build_all()
    wall = time.perf_counter() - tic
    for name, b in builds.items():
        ptxas = [ln.split("info    :")[-1].strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[2 build] {b.path.name} built in {b.seconds:.2f} s; ptxas: {' | '.join(ptxas)}",
              flush=True)
    print(f"[2 build] {len(builds)} sources built in parallel in {wall:.2f} s", flush=True)
    return builds


def _time_ms(fn, reps: int = 15) -> float:
    """Median of per-call CUDA-event times after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel(dev):
    """The axis-stencil kernel (slice 1) against its plain version."""
    import torch

    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil
    from pyapes_tpu_torch.ops.stencil import apply_axis_stencil

    worst = 0.0
    timing = None
    for seed, (shape, dtname) in enumerate(KERNEL_SHAPES):
        dtype = getattr(torch, dtname)
        g = torch.Generator(device=dev).manual_seed(seed)
        coeffs = tuple(
            tuple(torch.randn(n, generator=g, device=dev, dtype=dtype) for _ in range(3))
            for n in shape[1:]
        )
        x = torch.randn(shape, generator=g, device=dev, dtype=dtype)
        out = axis_stencil(coeffs, x)
        ref = apply_axis_stencil(coeffs, x)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = err <= REL_TOL[dtname] * scale
        print(
            f"[3 kernel] axis_stencil {tuple(shape)} {dtname}: max_abs_err={err:.3e} "
            f"(limit {REL_TOL[dtname]:.0e} x max|out| {scale:.3e}) {'ok' if ok else 'FAIL'}",
            flush=True,
        )
        if not ok:
            raise RuntimeError(f"chip_smoke: kernel disagrees with plain version at {shape}")
        worst = max(worst, err)
        if shape == (1, N_MAIN, N_MAIN, N_MAIN):
            ms = _time_ms(lambda: axis_stencil(coeffs, x))
            plain_ms = _time_ms(lambda: apply_axis_stencil(coeffs, x))
            gbs = 2 * x.numel() * x.element_size() / (ms * 1e-3) / 1e9
            timing = (ms, plain_ms)
            print(
                f"[3 kernel] axis_stencil {N_MAIN}^3 f32 time: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms (median of 15 CUDA-event timings); kernel moves >= "
                f"{gbs:.1f} GB/s (2 grids of compulsory traffic)",
                flush=True,
            )
        del out, ref, x
    return worst, timing


def _level_inputs(shape, dtype, dev, seed):
    """A V-cycle level's operands at ``shape`` (unit box): inv_dx2,
    omega/diag, x, b (b at the operator's scale, so out is O(1))."""
    import torch

    inv = [float((n - 1) ** 2) for n in shape[1:]]
    beta = 0.857 / (-2.0 * sum(inv))
    g = torch.Generator(device=dev).manual_seed(seed)
    gen = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.randn(shape, generator=g, device=dev, dtype=gen).to(dtype)
    b = (sum(inv) * torch.randn(shape, generator=g, device=dev, dtype=gen)).to(dtype)
    coeffs = tuple(
        tuple(torch.randn(n, generator=g, device=dev, dtype=gen).to(dtype) for _ in range(3))
        for n in shape[1:]
    )
    return inv, beta, x, b, coeffs


def _slice2_cases(inv, beta, x, b, coeffs):
    """(kernel name, variant, kernel call, plain call, dot-terms operand)
    for every variant of the four slice-2 kernels at one input."""
    from pyapes_tpu_torch.ops import stencil as P
    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil_dot
    from pyapes_tpu_torch.ops.jacobi import jacobi3d, jacobi3d_dot, jacobi3d_x2

    ax = (0, 1, 2)
    return [
        ("axis_stencil_dot", "", lambda: axis_stencil_dot(coeffs, x),
         lambda: P.apply_axis_stencil_dot(coeffs, x), x),
        ("jacobi3d", "smooth", lambda: jacobi3d(x, b, inv, 1.0, beta, ax),
         lambda: P.apply_jacobi3d(x, b, inv, 1.0, beta, ax), None),
        ("jacobi3d", "residual(alpha=0,beta=1)", lambda: jacobi3d(x, b, inv, 0.0, 1.0, ax),
         lambda: P.apply_jacobi3d(x, b, inv, 0.0, 1.0, ax), None),
        ("jacobi3d_dot", "", lambda: jacobi3d_dot(x, b, inv, 1.0, beta, ax),
         lambda: P.apply_jacobi3d_dot(x, b, inv, 1.0, beta, ax), b),
        ("jacobi3d_x2", "", lambda: jacobi3d_x2(x, b, inv, beta, ax),
         lambda: P.apply_jacobi3d_x2(x, b, inv, beta, ax), None),
        ("jacobi3d_x2", "from_zero", lambda: jacobi3d_x2(None, b, inv, beta, ax, from_zero=True),
         lambda: P.apply_jacobi3d_x2(None, b, inv, beta, ax, from_zero=True), None),
        ("jacobi3d_x2", "emit_dot", lambda: jacobi3d_x2(x, b, inv, beta, ax, emit_dot=True),
         lambda: P.apply_jacobi3d_x2(x, b, inv, beta, ax, emit_dot=True), b),
        ("jacobi3d_x2", "from_zero+emit_dot",
         lambda: jacobi3d_x2(None, b, inv, beta, ax, from_zero=True, emit_dot=True),
         lambda: P.apply_jacobi3d_x2(None, b, inv, beta, ax, from_zero=True, emit_dot=True), b),
    ]


def phase_kernel_slice2(dev):
    """The stencil alpha-dot and the Jacobi family against their plain
    versions at every shape x dtype x variant, dots included; kernel vs
    plain timed at 512^3 (bf16 for the Jacobi family, the cycle dtype;
    f32 for the alpha-dot, the CG dtype). Returns per-kernel worst abs
    error and (ms, plain_ms)."""
    import torch

    worst = {}
    timing = {}
    timed = {("axis_stencil_dot", "", "float32"), ("jacobi3d", "smooth", "bfloat16"),
             ("jacobi3d_dot", "", "bfloat16"), ("jacobi3d_x2", "", "bfloat16")}
    for seed, shape in enumerate(KERNEL3D_SHAPES):
        for dtname in DTYPES:
            dtype = getattr(torch, dtname)
            inv, beta, x, b, coeffs = _level_inputs(shape, dtype, dev, 100 + seed)
            parts = []
            for name, variant, kern, plain, dot_op in _slice2_cases(inv, beta, x, b, coeffs):
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                out, rout = (got[0], ref[0]) if dot_op is not None else (got, ref)
                if out.dtype != rout.dtype or out.shape != rout.shape:
                    raise RuntimeError(f"chip_smoke: {name} returned {out.dtype} {tuple(out.shape)}")
                err = (out.double() - rout.double()).abs().max().item()
                limit = REL_TOL[dtname] * rout.double().abs().max().item()
                ok = err <= limit
                tag = f"{name}{'[' + variant + ']' if variant else ''}"
                if dot_op is not None:
                    terms = (dot_op.double() * rout.double()).abs().sum(dim=(1, 2, 3))
                    derr = (got[1].double() - ref[1].double()).abs().flatten()
                    dlim = DOT_TOL[dtname] * terms
                    ok = ok and bool((derr <= dlim).all())
                    tag += f" dot_err={derr.max().item():.2e}/{dlim.min().item():.2e}"
                parts.append(f"{tag} {err:.2e}/{limit:.2e}{'' if ok else ' FAIL'}")
                if not ok:
                    print(f"[3 kernel] {tuple(shape)} {dtname}: " + "; ".join(parts), flush=True)
                    raise RuntimeError(f"chip_smoke: {name} {variant} disagrees with its plain "
                                       f"version at {shape} {dtname}")
                worst[name] = max(worst.get(name, 0.0), err)
                if shape[1] == N_MAIN and (name, variant, dtname) in timed:
                    timing[name] = (_time_ms(kern), _time_ms(plain))
                del got, ref, out, rout
            print(f"[3 kernel] {tuple(shape)} {dtname} err/limit: " + "; ".join(parts), flush=True)
            del x, b
    for name, (ms, plain_ms) in timing.items():
        grids = 2 if name == "axis_stencil_dot" else 3
        size = 4 if name == "axis_stencil_dot" else 2
        gbs = grids * N_MAIN**3 * size / (ms * 1e-3) / 1e9
        print(f"[3 kernel] {name} {N_MAIN}^3 {'f32' if size == 4 else 'bf16'} time: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 15 CUDA-event timings); kernel "
              f"moves >= {gbs:.1f} GB/s ({grids} grids of compulsory traffic)", flush=True)
    return worst, timing


def _solve_path(dev, n, cfg, label):
    """One warm-up and three timed solves of the 3-D f32 all-Dirichlet
    random-RHS Poisson problem through the public API; returns its stats
    (launches per timed solve included)."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.ops.stencil import apply_axis_stencil, laplacian_axis_coeffs
    from pyapes_tpu_torch.solver.fdm import FDM
    from pyapes_tpu_torch.solver.ops import Solver
    from pyapes_tpu_torch.utils.carry import coeffs_from_numpy
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    tol = cfg["tol"]
    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n, n, n], device=str(dev), dtype="single")
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet"), "obstacle": None},
                init_val=0.0)
    g = torch.Generator(device=mesh.device).manual_seed(0)
    rhs = torch.randn((1, n, n, n), generator=g, device=mesh.device, dtype=torch.float32)
    solver = Solver({"fdm": cfg})
    fdm = FDM()

    torch.cuda.synchronize()
    tic = time.perf_counter()
    solver.set_eq(fdm.laplacian(1.0, var) == rhs)
    solver.solve()
    torch.cuda.synchronize()
    first = time.perf_counter() - tic

    torch.cuda.reset_peak_memory_stats()
    walls, reports, per_solve = [], [], []
    for _ in range(3):
        var.set_var_tensor(torch.zeros_like(var()))
        solver.set_eq(fdm.laplacian(1.0, var) == rhs)
        torch.cuda.synchronize()
        before = _counts()
        tic = time.perf_counter()
        rep = solver.solve()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - tic)
        after = _counts()
        per_solve.append({k: after[k] - before[k] for k in after})
        reports.append(rep)
        if not (rep["converge"] and rep["tol"] <= tol):
            raise RuntimeError(f"chip_smoke: {label} {n}^3 solve did not converge: {rep}")
    peak = torch.cuda.max_memory_allocated()

    # True relative residual, recomputed with the PLAIN stencil.
    x = var()
    inner = (slice(None),) + (slice(1, -1),) * 3
    coeffs = coeffs_from_numpy(laplacian_axis_coeffs(mesh, var.bcs), mesh.device, torch.float32)
    res32 = ((rhs - apply_axis_stencil(coeffs, x))[inner].norm() / rhs[inner].norm()).item()
    c64 = tuple(tuple(c.double() for c in cs) for cs in coeffs)
    r64 = rhs.double()
    res64 = ((r64 - apply_axis_stencil(c64, x.double()))[inner].norm() / r64[inner].norm()).item()
    med = statistics.median(walls)
    stats = {
        "path": label, "n": n, "itr": [r["itr"] for r in reports],
        "tol": [r["tol"] for r in reports], "converge": [r["converge"] for r in reports],
        "first_call_s": first, "wall_s": walls, "wall_s_median": med,
        "dof_per_s": n**3 / med, "peak_mem_gib": peak / 2**30,
        "true_rel_residual_f32": res32, "true_rel_residual_f64": res64,
        "launches_per_solve": per_solve,
    }
    return stats, x


def phase_fastdiag(dev, n: int = N_MAIN):
    """The slice-1 main path: 512^3 fastdiag."""
    tol = 1e-6
    _reset_counts()
    stats, _ = _solve_path(dev, n, {"method": "fastdiag", "tol": tol, "max_it": 4000,
                                    "criterion": "residual"}, "fastdiag")
    counts = _counts()
    for rep_itr, ls in zip(stats["itr"], stats["launches_per_solve"]):
        if ls["axis_stencil"] < rep_itr + 1:
            raise RuntimeError("chip_smoke: the solve did not go through the stencil kernel")
    if not stats["true_rel_residual_f32"] <= tol:
        raise RuntimeError(f"chip_smoke: recomputed true residual "
                           f"{stats['true_rel_residual_f32']:.3e} > {tol}")
    print(f"[4 fastdiag path] {json.dumps(stats)}", flush=True)
    return {"axis_stencil": counts["axis_stencil"]}


def phase_mgpcg(dev, n: int, mg_opts: dict, required: tuple, label: str):
    """MG-PCG through ``Solver.solve`` with ``bench.py``'s cg settings;
    every kernel in ``required`` must launch in every timed solve."""
    _reset_counts()
    cfg = {"method": "cg", "precond": "mg", "tol": 1e-6, "max_it": 200,
           "criterion": "residual", "donate": True, "mg_opts": mg_opts}
    stats, _ = _solve_path(dev, n, cfg, label)
    counts = _counts()
    for ls in stats["launches_per_solve"]:
        missing = [k for k in required if ls[k] == 0]
        if missing:
            raise RuntimeError(f"chip_smoke: {label} did not launch {missing}: {ls}")
    # the criterion is the RECURSIVE residual: hold the true one to 1e-5
    if not stats["true_rel_residual_f32"] <= 1e-5:
        raise RuntimeError(f"chip_smoke: {label} true residual "
                           f"{stats['true_rel_residual_f32']:.3e} > 1e-5")
    print(f"[5 MG-PCG path] {json.dumps(stats)}", flush=True)
    return counts


def _poisson_model_error(n: int) -> tuple[float, float, dict]:
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import PoissonSolver
    from pyapes_tpu_torch.testing.poisson import poisson_bcs, poisson_exact_nd, poisson_rhs_nd

    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device="cuda", dtype="double")
    model = PoissonSolver(mesh, poisson_bcs(3))
    model.solve(poisson_rhs_nd(mesh, model.var))
    if not model.report["converge"]:
        raise RuntimeError(f"chip_smoke: PoissonSolver {n}^3 did not converge: {model.report}")
    exact = poisson_exact_nd(mesh)
    rel = ((model.var()[0] - exact).abs().max() / exact.abs().max()).item()
    h = 1.0 / (n - 1)
    # the discrete operator's eigenvalue for sin(pi x)sin(pi y)sin(pi z)
    predicted = 3 * pi**2 / (3 * (4 / h**2) * sin(pi * h / 2) ** 2) - 1.0
    return rel, predicted, model.report


def phase_model():
    _reset_counts()
    out = {}
    for n in (65, 129):
        rel, predicted, rep = _poisson_model_error(n)
        if abs(rel / predicted - 1.0) > 0.05:
            raise RuntimeError(
                f"chip_smoke: PoissonSolver {n}^3 error {rel:.3e} is not the predicted "
                f"discretization error {predicted:.3e}"
            )
        out[n] = (rel, predicted, rep)
    ratio = out[65][0] / out[129][0]
    print(
        "[6 model] PoissonSolver f64: "
        + "; ".join(f"{n}^3 itr={r['itr']} tol={r['tol']:.2e} rel_err={e:.4e} "
                    f"(predicted {p:.4e})" for n, (e, p, r) in out.items())
        + f"; error ratio 65->129 = {ratio:.3f} (second order: ~4)",
        flush=True,
    )
    counts = _counts()
    if counts["axis_stencil"] == 0:
        raise RuntimeError("chip_smoke: the model path launched no axis-stencil kernel")
    return {"axis_stencil": counts["axis_stencil"]}


def main() -> None:
    import torch

    dev, _ = phase_device()
    phase_build()
    worst1, timing1 = phase_kernel(dev)
    worst2, timing2 = phase_kernel_slice2(dev)
    worst = {"axis_stencil": worst1, **worst2}
    timing = {"axis_stencil": timing1, **timing2}

    launches = {name: 0 for name, _, _, _ in KERNELS}
    path_counts = [
        phase_fastdiag(dev),
        phase_mgpcg(dev, N_MAIN, BENCH_MG, ("axis_stencil_dot", "jacobi3d", "jacobi3d_x2"),
                    f"MG-PCG {N_MAIN}^3 bf16 V(2,2) FMG fuse_rz"),
        phase_mgpcg(dev, N_V11, V11_MG, ("axis_stencil_dot", "jacobi3d", "jacobi3d_dot"),
                    f"MG-PCG {N_V11}^3 bf16 V(1,1) FMG fuse_rz"),
        phase_model(),
    ]
    for counts in path_counts:
        for name, c in counts.items():
            launches[name] += c
    never = [name for name, c in launches.items() if c == 0]
    if never:
        raise RuntimeError(f"chip_smoke: the main paths never launched {never}")

    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": worst[name],
        "ms": timing[name][0],
        "plain_ms": timing[name][1],
    } for name, _, source, replaces in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
