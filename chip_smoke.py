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
   five shapes x f32/bf16/f64 x their variants, dots included; the
   variable-Γ diffusion apply and Jacobi pass: the same shapes plus a 2-D
   grid x f32/bf16/f64 x isotropic/stacked Γ x arithmetic/harmonic faces x
   no/Neumann surgery x the three Jacobi modes), and kernel vs plain timed
   at 512^3 (CUDA events).
4. fastdiag path — the 512^3 f32 all-Dirichlet random-RHS Poisson solve
   through ``Solver.solve`` (fastdiag), as ``bench.py`` drives the JAX
   package: one warm-up and three timed solves; convergence, kernel
   launches per solve, and the true residual recomputed independently.
5. MG-PCG path — the same problem through ``bench.py``'s cg config (bf16
   V(2,2), FMG, fused r.z) at 512^3, and a V(1,1) fused-r.z config at
   256^3 (where the Jacobi + dot kernel runs): the same checks, each
   kernel's launches per solve, the true residual in f32 and f64.
6. Darcy variable-Γ MG-PCG path — ``bench.py``'s ``bench_darcy`` problem
   (256^3 f32, Γ = exp(0.8 sin 2πx sin 2πy sin 2πz), bf16 V(2,2) FMG)
   through ``Solver.solve``: the same checks, the true residual
   recomputed with the plain variable-Γ operator.
7. model — ``PoissonSolver`` on the runner's 3-D problem at 65^3 and 129^3
   (f64): convergence, and the error against the exact solution equal to
   the predicted discretization error; the runner's ``darcy`` case (2-D,
   harmonic faces, MG-BiCGSTAB, f64) at 65^2 against the JAX package's
   numbers and at 1025^2: flux balance and the Wiener bounds.
8. advection kernels — the per-point Div and Conv kernels and the 5-point
   axis stencil against their plain versions (the 3-D shapes, a 2-D and a
   1-D grid, a 3-node axis with Neumann faces on both sides, mixed 3/5-point
   axes; f32/bf16/f64; every limiter, both Div forms, the surgery kinds
   none/neumann/periodic, scalar and vector targets), timed against the
   plain versions at 256^3 and 512^3 f32.
9. implicit-advection paths, f32 on one card, through the models' ``step``:
   ``BurgersND`` at 257^3 on the periodic box (Taylor-Green start, 3 steps
   of dt 0.01: 9 BiCGSTAB + FD-preconditioner solves through the convection
   kernel); ``AdvectionDiffusion`` at 256^3 with a velocity field (upwind,
   the Div kernel, 5 steps of dt 1e-3) and with a constant velocity and
   QUICK (the 5-point kernel, 3 steps); per path the wall per step (median
   after the first, warm-up, step), ``itr`` per solve, kernel launches per
   step, peak memory, and the true relative residual of the last solve
   recomputed with the plain operators in f64. Then ``BurgersND`` at 257^3
   in f64 (the JAX test's precision) from an x-only field (the 1-D exact
   solution, nu = 0.25, 10 steps): v and w stay zero, u stays
   y/z-independent and matches the 1-D exact solution (the JAX package's
   gates).

Every kernel launch count is set to 0 just before each path (phases 4-7,
9) and read just after; a kernel of a path that launched no time there
fails the run. Then one JSON line of per-kernel numbers, and as the LAST line
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
    ("diff_field", "pyapes_tpu_torch.ops.diff_field",
     "pyapes_tpu_torch/csrc/diff_field.cu", "pyapes_tpu/ops/pallas_advect.py:519"),
    ("diff_jacobi", "pyapes_tpu_torch.ops.diff_field",
     "pyapes_tpu_torch/csrc/diff_field.cu", "pyapes_tpu/ops/pallas_advect.py:694"),
    ("conv_component", "pyapes_tpu_torch.ops.advect",
     "pyapes_tpu_torch/csrc/advect.cu", "pyapes_tpu/ops/pallas_advect.py:296"),
    ("advect_pair", "pyapes_tpu_torch.ops.advect",
     "pyapes_tpu_torch/csrc/advect.cu", "pyapes_tpu/ops/pallas_advect.py:357"),
    ("axis_stencil5", "pyapes_tpu_torch.ops.axis_stencil",
     "pyapes_tpu_torch/csrc/axis_stencil.cu", "pyapes_tpu/ops/pallas_stencil_v3.py:424"),
]
# the variable-Γ kernels: the 3-D shapes plus a 2-D grid; per shape and
# dtype four (stacked Γ, face rule, Neumann surgery) combinations that
# cover each option
VG_SHAPES = KERNEL3D_SHAPES + [(1, 1025, 1025)]
VG_COMBOS = [(False, "arithmetic", False), (False, "harmonic", True),
             (True, "arithmetic", True), (True, "harmonic", False)]
N_DARCY = 256
# bench.py's bench_darcy configuration
DARCY_MG = {"dtype": "bfloat16", "n_pre": 2, "n_post": 2, "omega": 0.857, "fmg": True}
# the JAX package's `runner darcy --n 65 --dtype double` (avg arithmetic) and
# `--avg harmonic`: k_eff on the CPU, float64
DARCY65_K_EFF = {"arithmetic": 0.8474604795147054, "harmonic": 0.8394676532747538}
# bench.py's PYAPES_BENCH_METHOD=cg configuration
BENCH_MG = {"dtype": "bfloat16", "n_pre": 2, "n_post": 2, "omega": 0.857, "fmg": True,
            "fuse_rz": True}
V11_MG = {**BENCH_MG, "n_pre": 1, "n_post": 1}
# the advection kernels: the 3-D shapes (512^3 is timed separately), a
# 3-node axis (axis 0, Neumann on both faces in the "neumann" kind), a 2-D
# and a 1-D grid
ADV_SHAPES = [(3, 64, 64, 64), (1, 65, 33, 129), (1, 4, 4, 4), (1, 5, 9, 17), (3, 3, 9, 11),
              (1, 65, 130), (2, 300)]
ADV_SURGERY = {  # per kind, the (lower, upper) faces of axes 0, 1, 2
    "none": (("none", "none"),) * 3,
    "neumann": (("neumann", "neumann"),) * 3,
    "mixed": (("periodic", "neumann"), ("none", "periodic"), ("neumann", "none")),
}
DIV_VARIANTS = [("none", "conservative"), ("none", "advective"), ("upwind", "conservative"),
                ("quick", "conservative")]
N_ADV = (256, 512)  # timed sizes (f32)
N_PATH = 256  # the implicit-advection paths' grid (Burgers: 257 nodes, 256 on the torus)


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


def _vg_cases(shape, inv, beta, x, b, g, avg, neumann):
    """(kernel name, variant, kernel call, plain call) for the variable-Γ
    apply and the three Jacobi modes at one input."""
    from pyapes_tpu_torch.ops import stencil as P
    from pyapes_tpu_torch.ops.diff_field import diff_field, diff_jacobi

    nd = len(shape) - 1
    mixed = (("neumann", "none"), ("none", "neumann"), ("neumann", "neumann"))
    surg = mixed[:nd] if neumann else (("none", "none"),) * nd
    axes = tuple(range(nd))
    omega = 0.857
    cases = [("diff_field", "", lambda: diff_field(x, g, inv, surg, avg),
              lambda: P.apply_diff_field(x, g, inv, surg, avg))]
    for mode in ("smooth", "smooth0", "resid"):
        xm = None if mode == "smooth0" else x
        cases.append((
            "diff_jacobi", mode,
            lambda xm=xm, mode=mode: diff_jacobi(xm, b, g, inv, surg, avg, omega, axes, mode),
            lambda xm=xm, mode=mode: P.apply_diff_jacobi(xm, b, g, inv, surg, avg, omega, axes,
                                                         mode),
        ))
    return cases


def phase_kernel_vargamma(dev):
    """The variable-Γ diffusion apply and Jacobi pass against their plain
    versions at every shape x dtype x (Γ layout, face rule, surgery) x
    mode; kernel vs plain timed at 512^3 (f32 for the apply, the outer
    operator's dtype; bf16 for the Jacobi pass, the cycle dtype)."""
    import torch

    worst, timing = {}, {}
    timed = {("diff_field", "", "float32"), ("diff_jacobi", "smooth", "bfloat16")}
    for seed, shape in enumerate(VG_SHAPES):
        for dtname in DTYPES:
            dtype = getattr(torch, dtname)
            inv, beta, x, b, _ = _level_inputs(shape, dtype, dev, 200 + seed)
            gen = torch.Generator(device=dev).manual_seed(300 + seed)
            nd = len(shape) - 1
            gstack = (1.0 + torch.rand((nd, *shape[1:]), generator=gen, device=dev)).to(dtype)
            parts = []
            for aniso, avg, neumann in VG_COMBOS:
                g = gstack if aniso else gstack[0]
                for name, variant, kern, plain in _vg_cases(shape, inv, beta, x, b, g, avg,
                                                             neumann):
                    got, ref = kern(), plain()
                    torch.cuda.synchronize()
                    if got.dtype != ref.dtype or got.shape != ref.shape:
                        raise RuntimeError(f"chip_smoke: {name} returned {got.dtype} "
                                           f"{tuple(got.shape)}")
                    err = (got.double() - ref.double()).abs().max().item()
                    limit = REL_TOL[dtname] * ref.double().abs().max().item()
                    tag = (f"{name}{'[' + variant + ']' if variant else ''}"
                           f"({'stacked' if aniso else 'iso'},{avg[:4]},"
                           f"{'neu' if neumann else 'none'})")
                    parts.append(f"{tag} {err:.2e}/{limit:.2e}{'' if err <= limit else ' FAIL'}")
                    if not err <= limit:
                        print(f"[3 kernel] {tuple(shape)} {dtname}: " + "; ".join(parts),
                              flush=True)
                        raise RuntimeError(f"chip_smoke: {name} {variant} disagrees with its "
                                           f"plain version at {shape} {dtname}")
                    worst[name] = max(worst.get(name, 0.0), err)
                    if (shape[1] == N_MAIN and not aniso and avg == "arithmetic"
                            and (name, variant, dtname) in timed):
                        timing[name] = (_time_ms(kern), _time_ms(plain))
                    del got, ref
            print(f"[3 kernel] {tuple(shape)} {dtname} err/limit: " + "; ".join(parts), flush=True)
            del x, b, gstack
    for name, (ms, plain_ms) in timing.items():
        grids = 3 if name == "diff_field" else 4
        size = 4 if name == "diff_field" else 2
        gbs = grids * N_MAIN**3 * size / (ms * 1e-3) / 1e9
        print(f"[3 kernel] {name} {N_MAIN}^3 {'f32' if size == 4 else 'bf16'} time: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 15 CUDA-event timings); kernel "
              f"moves >= {gbs:.1f} GB/s ({grids} grids of compulsory traffic)", flush=True)
    return worst, timing


def _adv_inputs(shape, dtype, dev, seed):
    """A target, advectors (Div: as many components as the target; Conv:
    one per axis), base vectors of the unit box, and 5-point coefficients
    with axes 0 and 2 of 5 vectors and axis 1 of 3."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    gen = torch.float64 if dtype == torch.float64 else torch.float32
    nd = len(shape) - 1

    def rnd(*sh):
        return torch.randn(sh, generator=g, device=dev, dtype=gen).to(dtype)

    base = tuple(tuple(torch.full((n,), v, device=dev, dtype=gen).to(dtype)
                       for v in (0.5 * (n - 1), 0.0, -0.5 * (n - 1))) for n in shape[1:])
    c5 = tuple(tuple(rnd(n) for _ in range(3 if j == 1 else 5)) for j, n in enumerate(shape[1:]))
    return rnd(*shape), rnd(*shape), rnd(nd, *shape[1:]), base, c5


def _adv_cases(shape, x, adv, adv_conv, base, c5):
    """(kernel name, variant, kernel call, plain call) of the three
    advection kernels at one input."""
    from pyapes_tpu_torch.ops import stencil as P
    from pyapes_tpu_torch.ops.advect import advect_pair, conv_component
    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil5

    nd = len(shape) - 1
    cases = []
    for kind, surg in ADV_SURGERY.items():
        surg = surg[:nd]
        for lim, form in DIV_VARIANTS:
            for xs, av, tag in ((x, adv, f"vdim{shape[0]}"), (x[:1], adv[:1], "scalar")):
                cases.append(("advect_pair", f"{lim},{form[:4]},{kind},{tag}",
                              lambda xs=xs, av=av, lim=lim, form=form, surg=surg:
                              advect_pair(xs, av, base, lim, surg, form),
                              lambda xs=xs, av=av, lim=lim, form=form, surg=surg:
                              P.apply_div_field(xs, av, base, lim, surg, form)))
        for lim in ("none", "upwind", "quick"):
            cases.append(("conv_component", f"{lim},{kind}",
                          lambda lim=lim, surg=surg: conv_component(x, adv_conv, base, lim, surg),
                          lambda lim=lim, surg=surg: P.apply_conv_field(x, adv_conv, base, lim,
                                                                        surg)))
    cases.append(("axis_stencil5", "mixed 3/5", lambda: axis_stencil5(c5, x),
                  lambda: P.apply_axis_stencil(c5, x)))
    return cases


def phase_kernel_advect(dev):
    """The Div and Conv kernels and the 5-point axis stencil against their
    plain versions at every shape x dtype x case; kernel vs plain timed at
    256^3 and 512^3 f32 on the paths' cases (Div upwind, Conv central,
    QUICK's 5-point axes)."""
    import torch

    from pyapes_tpu_torch.ops import stencil as P
    from pyapes_tpu_torch.ops.advect import advect_pair, conv_component
    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil5

    worst = {}
    for seed, shape in enumerate(ADV_SHAPES):
        for dtname in DTYPES:
            dtype = getattr(torch, dtname)
            x, adv, adv_conv, base, c5 = _adv_inputs(shape, dtype, dev, 400 + seed)
            parts, fails = [], []
            for name, variant, kern, plain in _adv_cases(shape, x, adv, adv_conv, base, c5):
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                if got.dtype != ref.dtype or got.shape != ref.shape:
                    raise RuntimeError(f"chip_smoke: {name} returned {got.dtype} "
                                       f"{tuple(got.shape)}")
                err = (got.double() - ref.double()).abs().max().item()
                limit = REL_TOL[dtname] * ref.double().abs().max().item()
                worst[name] = max(worst.get(name, 0.0), err)
                parts.append(err / limit if limit > 0 else (0.0 if err == 0 else float("inf")))
                if not err <= limit:
                    fails.append(f"{name}[{variant}] {err:.2e}/{limit:.2e}")
            print(f"[8 advection kernels] {tuple(shape)} {dtname}: {len(parts)} cases, worst "
                  f"err/limit {max(parts):.3f}{'; FAIL ' + '; '.join(fails) if fails else ''}",
                  flush=True)
            if fails:
                raise RuntimeError(f"chip_smoke: advection kernels disagree with their plain "
                                   f"versions at {shape} {dtname}: {fails}")
            del x, adv, adv_conv
    timing = {}
    for n in N_ADV:
        shape = (1, n, n, n)
        x, adv, adv_conv, base, _ = _adv_inputs(shape, torch.float32, dev, 500 + n)
        c5 = tuple(tuple(torch.randn(n, device=dev) for _ in range(5)) for _ in range(3))
        surg = ADV_SURGERY["none"]
        timed = {
            "advect_pair": (lambda: advect_pair(x, adv, base, "upwind", surg),
                            lambda: P.apply_div_field(x, adv, base, "upwind", surg), 3),
            "conv_component": (lambda: conv_component(x, adv_conv, base, "none", surg),
                               lambda: P.apply_conv_field(x, adv_conv, base, "none", surg), 5),
            "axis_stencil5": (lambda: axis_stencil5(c5, x),
                              lambda: P.apply_axis_stencil(c5, x), 2),
        }
        for name, (kern, plain, grids) in timed.items():
            got, ref = kern(), plain()
            err = (got - ref).abs().max().item()
            limit = REL_TOL["float32"] * ref.abs().max().item()
            if not err <= limit:
                raise RuntimeError(f"chip_smoke: {name} disagrees at {n}^3: {err} > {limit}")
            worst[name] = max(worst[name], err)
            del got, ref
            ms, plain_ms = _time_ms(kern), _time_ms(plain)
            timing.setdefault(name, {})[n] = (ms, plain_ms)
            gbs = grids * n**3 * 4 / (ms * 1e-3) / 1e9
            print(f"[8 advection kernels] {name} {n}^3 f32 time: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (median of 15 CUDA-event timings); kernel moves >= "
                  f"{gbs:.1f} GB/s ({grids} grids of compulsory traffic)", flush=True)
        del x, adv, adv_conv, c5
    return worst, {name: t[N_PATH] for name, t in timing.items()}


def _true_residual(solver) -> float:
    """The TRUE relative residual ``|b - A x| / |b|`` of the solver's last
    equation over its active set, recomputed in f64 with the plain
    operators on the reduced torus of its periodic axes."""
    import numpy as np
    import torch

    from pyapes_tpu_torch.ops import stencil as P
    from pyapes_tpu_torch.solver.fdm import ddt_leading_coeff

    var = solver.var
    nd = var.mesh.dim
    per = [sum(bc.bc_type == "periodic" and bc.bc_face_dim == j for bc in var.bcs) == 2
           for j in range(nd)]
    red = (slice(None),) + tuple(slice(None, -1) if p else slice(None) for p in per)

    def vecs(cs_all):  # host vectors on the reduced torus, as f64 tensors
        out = []
        for j, cs in enumerate(cs_all):
            if per[j]:
                cs = [np.full(len(c) - 1, c[(len(c) - 1) // 2]) for c in cs]
            out.append(tuple(torch.as_tensor(np.asarray(c, np.float64), device=var().device)
                             for c in cs))
        return tuple(out)

    x, b = var()[red].double(), solver.rhs[red].double()
    ax = torch.zeros_like(x)
    for rec in solver.eqs.values():
        if rec["name"] == "Ddt":
            t = x * (ddt_leading_coeff(rec) / rec["dt"])
        elif rec.get("adv") is not None:
            o = rec["other"]
            surg = tuple(("none", "none") if per[j] else k for j, k in enumerate(o["surgery"]))
            adv = rec["adv"][red].double()
            if rec["name"] == "Conv":
                t = P.apply_conv_field(x, adv, vecs(o["base"]), rec["limiter"], surg)
            else:
                t = P.apply_div_field(x, adv, vecs(o["base"]), rec["limiter"], surg, o["form"])
        else:
            t = P.apply_axis_stencil(vecs(rec["axis_coeffs"]), x)
            if rec["name"] == "Laplacian" and rec["param"][0] is not None:
                t = t * float(rec["param"][0])
        ax = ax + rec["sign"] * t
    inner = (slice(None),) + tuple(slice(None) if p else slice(1, -1) for p in per)
    res, bn = (b - ax)[inner].norm().item(), b[inner].norm().item()
    return res / bn if bn > 0 else res  # a zero RHS (w of Taylor-Green): the absolute one


def _drive_steps(model, solver, n_steps: int, label: str, required: tuple) -> dict:
    """Step a model ``n_steps`` times through its public ``step``: wall per
    step (median after the first, warm-up, step), ``itr`` per solve,
    launches per step (every kernel in ``required`` in every step), peak
    memory over the steps after the first (the check's f64 temporaries left
    out) and what was allocated when that window opened, and each solve of
    the last step's true residual (recomputed after the step's wall is
    taken); every solve must converge."""
    import torch

    reports, residuals = [], []
    real_solve = solver.solve

    def solve():
        rep = real_solve()
        reports.append(dict(rep))
        if len(walls) == n_steps - 1:
            torch.cuda.synchronize()
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
            tic = time.perf_counter()
            residuals.append(_true_residual(solver))
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - tic
            torch.cuda.reset_peak_memory_stats()
        return rep

    solver.solve = solve
    walls, per_step, spent, peak, start = [], [], [0.0], [0], 0
    torch.cuda.synchronize()
    for k in range(n_steps):
        if k == 1:
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
        before = _counts()
        tic = time.perf_counter()
        model.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - tic - spent[0])
        after = _counts()
        per_step.append({name: after[name] - before[name] for name in after
                         if after[name] > before[name]})
    solver.solve = real_solve
    bad = [r for r in reports if not r["converge"]]
    if bad:
        raise RuntimeError(f"chip_smoke: {label}: a solve did not converge: {bad}")
    missing = [(k, name) for k, ls in enumerate(per_step) for name in required if not ls.get(name)]
    if missing:
        raise RuntimeError(f"chip_smoke: {label}: steps launched no {missing}: {per_step}")
    return {
        "path": label, "steps": n_steps, "wall_s": walls,
        "wall_s_per_step_median": statistics.median(walls[1:]),
        "itr": [r["itr"] for r in reports], "tol": [r["tol"] for r in reports],
        "launches_per_step": per_step,
        "peak_mem_gib": max(peak[0], torch.cuda.max_memory_allocated()) / 2**30,
        "mem_at_window_start_gib": start / 2**30, "true_rel_residual_f64_last_step": residuals,
    }


# the solves' criterion is BiCGSTAB's recursive residual (absolute, the
# models' "delta" criterion), which keeps falling past what an f32 iterate
# can hold; the true residual of the f32 solution is held to this bound
TRUE_RES_F32 = 1e-5


def _check_path(stats) -> None:
    worst = max(stats["true_rel_residual_f64_last_step"])
    if not worst <= TRUE_RES_F32:
        raise RuntimeError(f"chip_smoke: {stats['path']} true residual {worst:.3e} > "
                           f"{TRUE_RES_F32}")


def phase_burgers(dev, n: int = N_PATH) -> dict:
    """``BurgersND`` at (n+1)^3 f32 on the periodic box, Taylor-Green start,
    3 steps of dt 0.01 (BiCGSTAB + the frozen diffusion+dt FD
    preconditioner, tol 1e-8, the model's defaults)."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import BurgersND
    from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache

    mesh = Mesh(Box[0:2 * pi, 0:2 * pi, 0:2 * pi], None, [n + 1] * 3, device=str(dev),
                dtype="single")
    X, Y, Z = mesh.X, mesh.Y, mesh.Z
    init = [(torch.sin(X) * torch.cos(Y) * torch.cos(Z))[None],
            (-torch.cos(X) * torch.sin(Y) * torch.cos(Z))[None], torch.zeros((1, *mesh.nx))]
    clear_cache()  # the earlier phases' cached hierarchies and factors
    model = BurgersND(mesh, nu=0.1, init_vals=init)
    _reset_counts()
    stats = _drive_steps(_Stepper(model, 0.01), model.solver, 3,
                         f"BurgersND {n + 1}^3 f32 Taylor-Green",
                         ("conv_component", "axis_stencil"))
    counts = _counts()
    _check_path(stats)
    u = torch.cat([v() for v in model.vel])
    if not bool(u.isfinite().all()) or tuple(u.shape) != (3, n + 1, n + 1, n + 1):
        raise RuntimeError("chip_smoke: BurgersND velocity is not finite of shape (3, n^3)")
    print(f"[9 Burgers path] {json.dumps(stats)}", flush=True)
    return counts


class _Stepper:
    """``step()`` of a model at a fixed dt."""

    def __init__(self, model, dt):
        self.model, self.dt = model, dt

    def step(self):
        self.model.step(self.dt)


def phase_advdiff(dev, n: int = N_PATH) -> dict:
    """``AdvectionDiffusion`` at n^3 f32 on the unit box with homogeneous
    Dirichlet faces, eps = 0.01, a Gaussian blob: (a) the velocity field
    1 + 0.5 sin 2πx sin 2πy sin 2πz, upwind, 5 steps of dt 1e-3; (b) the
    constant velocity 1 with QUICK, 3 steps."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import AdvectionDiffusion
    from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device=str(dev), dtype="single")
    X, Y, Z = mesh.X, mesh.Y, mesh.Z
    blob = torch.exp(-((X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Z - 0.5) ** 2) / (2 * 0.1**2))[None]
    vel = (1.0 + 0.5 * torch.sin(2 * pi * X) * torch.sin(2 * pi * Y)
           * torch.sin(2 * pi * Z))[None].contiguous()
    counts = {}
    for velocity, limiter, steps, required, label in (
        (vel, "upwind", 5, ("advect_pair", "axis_stencil"),
         f"AdvectionDiffusion {n}^3 f32 velocity field, upwind"),
        (1.0, "quick", 3, ("axis_stencil5", "axis_stencil"),
         f"AdvectionDiffusion {n}^3 f32 constant velocity, QUICK"),
    ):
        model = None
        clear_cache()
        model = AdvectionDiffusion(mesh, homogeneous_bcs(3, 0.0, "dirichlet"), velocity=velocity,
                                   epsilon=0.01, limiter=limiter, init_val=blob)
        _reset_counts()
        stats = _drive_steps(_Stepper(model, 1e-3), model.solver, steps, label, required)
        for name, c in _counts().items():
            counts[name] = counts.get(name, 0) + c
        _check_path(stats)
        phi = model.var()
        if not bool(phi.isfinite().all()) or tuple(phi.shape) != (1, n, n, n):
            raise RuntimeError(f"chip_smoke: {label}: phi is not finite of shape (1, n^3)")
        print(f"[9 advection-diffusion path] {json.dumps(stats)}", flush=True)
    return counts


def phase_burgers_xonly(dev, n: int = N_PATH) -> None:
    """``BurgersND`` at (n+1)^3 f64 from an x-only field, the 1-D exact
    solution (nu = 0.25) broadcast along y and z, v = w = 0, 10 steps of dt
    0.01 (f64, as the JAX test: 1e-6 of y/z spread is ~2 f32 ulps of u ~ 4,
    below the rounding of an f32 eigen-transform):
    v and w stay below 1e-6, u y/z-independent to 1e-6, and u matches the
    1-D exact solution to a relative L2 error under 0.05 (and a max error
    under 1.2, the scheme's floor at the front) — the JAX package's gates
    (``tests/test_models.py:376-409``)."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import BurgersND
    from pyapes_tpu_torch.testing.burgers import burger_exact_nd

    nu, dt, steps = 0.25, 0.01, 10
    mesh1 = Mesh(Box[0:2 * pi], None, [n + 1], device=str(dev), dtype="double")
    mesh = Mesh(Box[0:2 * pi, 0:2 * pi, 0:2 * pi], None, [n + 1] * 3, device=str(dev),
                dtype="double")
    u0 = burger_exact_nd(mesh1, nu, 0.0)[None, :, None, None].expand(1, n + 1, n + 1, n + 1)
    zero = torch.zeros((1, *mesh.nx))
    model = BurgersND(mesh, nu=nu, init_vals=[u0.contiguous(), zero, zero])
    tic = time.perf_counter()
    model.run(dt, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    u, v, w = (f()[0] for f in model.vel)
    vw = max(v.abs().max().item(), w.abs().max().item())
    spread = (u - u[:, :1, :1]).abs().max().item()
    exact = burger_exact_nd(mesh1, nu, dt * steps)
    err = u[:, 0, 0] - exact
    rel_l2 = (err.norm() / exact.norm()).item()
    out = {"steps": steps, "wall_s": wall, "max_abs_vw": vw, "max_yz_spread_u": spread,
           "rel_l2_vs_exact": rel_l2, "max_abs_err": err.abs().max().item(),
           "last_itr": model.report["itr"]}
    if not (vw < 1e-6 and spread < 1e-6 and rel_l2 < 0.05 and out["max_abs_err"] < 1.2):
        raise RuntimeError(f"chip_smoke: x-only Burgers {n + 1}^3 failed its gates: {out}")
    print(f"[9 Burgers x-only check] {n + 1}^3 f64 nu={nu}: {json.dumps(out)}", flush=True)


def _solve_path(dev, n, cfg, label, darcy=False):
    """One warm-up and three timed solves of the 3-D f32 all-Dirichlet
    random-RHS Poisson problem through the public API (with ``darcy``:
    ``bench_darcy``'s variable-Γ problem); returns its stats (launches per
    timed solve included) and the solution."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.ops.stencil import (
        apply_axis_stencil,
        apply_diff_field,
        div_surgery_info,
        laplacian_axis_coeffs,
    )
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
    coeff = 1.0
    if darcy:
        coeff = torch.exp(0.8 * torch.sin(2 * pi * mesh.X) * torch.sin(2 * pi * mesh.Y)
                          * torch.sin(2 * pi * mesh.Z)).contiguous()
    solver = Solver({"fdm": cfg})
    fdm = FDM()

    torch.cuda.synchronize()
    tic = time.perf_counter()
    solver.set_eq(fdm.laplacian(coeff, var) == rhs)
    solver.solve()
    torch.cuda.synchronize()
    first = time.perf_counter() - tic

    torch.cuda.reset_peak_memory_stats()
    walls, reports, per_solve = [], [], []
    for _ in range(3):
        var.set_var_tensor(torch.zeros_like(var()))
        solver.set_eq(fdm.laplacian(coeff, var) == rhs)
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

    # True relative residual, recomputed with the PLAIN operator.
    x = var()
    inner = (slice(None),) + (slice(1, -1),) * 3
    if darcy:
        inv = tuple(1.0 / float(d) ** 2 for d in mesh.dx_np)
        surg = div_surgery_info(var.bcs, 3)

        def plain_A(v, dtype):
            return apply_diff_field(v.to(dtype), coeff.to(dtype), inv, surg)
    else:
        c32 = coeffs_from_numpy(laplacian_axis_coeffs(mesh, var.bcs), mesh.device, torch.float32)

        def plain_A(v, dtype):
            return apply_axis_stencil(tuple(tuple(c.to(dtype) for c in cs) for cs in c32),
                                      v.to(dtype))
    res32 = ((rhs - plain_A(x, torch.float32))[inner].norm() / rhs[inner].norm()).item()
    r64 = rhs.double()
    res64 = ((r64 - plain_A(x, torch.float64))[inner].norm() / r64[inner].norm()).item()
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


def phase_darcy(dev, n: int = N_DARCY):
    """The variable-Γ path: ``bench_darcy``'s problem through
    ``Solver.solve`` (CG, Γ-aware MG, bf16 V(2,2), FMG); both variable-Γ
    kernels must launch in every timed solve."""
    _reset_counts()
    cfg = {"method": "cg", "precond": "mg", "tol": 1e-6, "max_it": 400,
           "criterion": "residual", "mg_opts": DARCY_MG}
    label = f"Darcy variable-Γ MG-PCG {n}^3 bf16 V(2,2) FMG"
    stats, x = _solve_path(dev, n, cfg, label, darcy=True)
    counts = _counts()
    for ls in stats["launches_per_solve"]:
        missing = [k for k in ("diff_field", "diff_jacobi") if ls[k] == 0]
        if missing:
            raise RuntimeError(f"chip_smoke: {label} did not launch {missing}: {ls}")
    if not (stats["true_rel_residual_f32"] <= 1e-5 and stats["true_rel_residual_f64"] <= 1e-5):
        raise RuntimeError(f"chip_smoke: {label} true residual {stats['true_rel_residual_f32']:.3e}"
                           f" / {stats['true_rel_residual_f64']:.3e} > 1e-5")
    if not bool(x.isfinite().all()) or tuple(x.shape) != (1, n, n, n):
        raise RuntimeError(f"chip_smoke: {label} solution is not finite of shape (1, {n}^3)")
    print(f"[6 Darcy path] {json.dumps(stats)}", flush=True)
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


def _darcy_model(n: int, avg: str) -> dict:
    from pyapes_tpu_torch import runner

    out = runner.run(["darcy", "--n", str(n), "--avg", avg, "--dtype", "double",
                      "--device", "cuda"])
    q_in, q_out, k = out["flux_in"], out["flux_out"], out["k_eff"]
    if not out["report"]["converge"]:
        raise RuntimeError(f"chip_smoke: runner darcy {n}^2 did not converge: {out}")
    # the JAX runner demo's gates: 2% flux balance, the Wiener bounds
    if not abs(q_in - q_out) <= 0.02 * abs(q_in):
        raise RuntimeError(f"chip_smoke: runner darcy {n}^2 flux imbalance: {out}")
    if not out["k_harmonic"] - 1e-6 <= k <= out["k_arithmetic"] + 1e-6:
        raise RuntimeError(f"chip_smoke: runner darcy {n}^2 k_eff outside the Wiener bounds: {out}")
    return out


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
        "[7 model] PoissonSolver f64: "
        + "; ".join(f"{n}^3 itr={r['itr']} tol={r['tol']:.2e} rel_err={e:.4e} "
                    f"(predicted {p:.4e})" for n, (e, p, r) in out.items())
        + f"; error ratio 65->129 = {ratio:.3f} (second order: ~4)",
        flush=True,
    )
    counts = _counts()
    if counts["axis_stencil"] == 0:
        raise RuntimeError("chip_smoke: the model path launched no axis-stencil kernel")
    # a 65^2 run of each face rule against the JAX package's numbers; the
    # path's own size, 1025^2 with harmonic faces, with its launch counts
    for avg, k_ref in DARCY65_K_EFF.items():
        small = _darcy_model(65, avg)
        if not abs(small["k_eff"] - k_ref) <= 1e-9 * k_ref:
            raise RuntimeError(f"chip_smoke: runner darcy 65^2 {avg} k_eff {small['k_eff']!r} "
                               f"differs from the JAX package's {k_ref!r}")
    _reset_counts()
    big = _darcy_model(1025, "harmonic")
    dcounts = _counts()
    if dcounts["diff_field"] == 0 or dcounts["diff_jacobi"] == 0:
        raise RuntimeError(f"chip_smoke: the Darcy model launched no variable-Γ kernel: {dcounts}")
    print(f"[7 model] runner darcy 65^2 f64 k_eff matches the JAX package (arithmetic, "
          f"harmonic); 1025^2 f64 harmonic: {json.dumps(big)}", flush=True)
    return {"axis_stencil": counts["axis_stencil"], "diff_field": dcounts["diff_field"],
            "diff_jacobi": dcounts["diff_jacobi"]}


def main() -> None:
    import torch

    dev, _ = phase_device()
    phase_build()
    worst1, timing1 = phase_kernel(dev)
    worst2, timing2 = phase_kernel_slice2(dev)
    worst3, timing3 = phase_kernel_vargamma(dev)
    worst4, timing4 = phase_kernel_advect(dev)
    worst = {"axis_stencil": worst1, **worst2, **worst3, **worst4}
    timing = {"axis_stencil": timing1, **timing2, **timing3, **timing4}

    launches = {name: 0 for name, _, _, _ in KERNELS}
    path_counts = [
        phase_fastdiag(dev),
        phase_mgpcg(dev, N_MAIN, BENCH_MG, ("axis_stencil_dot", "jacobi3d", "jacobi3d_x2"),
                    f"MG-PCG {N_MAIN}^3 bf16 V(2,2) FMG fuse_rz"),
        phase_mgpcg(dev, N_V11, V11_MG, ("axis_stencil_dot", "jacobi3d", "jacobi3d_dot"),
                    f"MG-PCG {N_V11}^3 bf16 V(1,1) FMG fuse_rz"),
        phase_darcy(dev),
        phase_model(),
        phase_burgers(dev),
        phase_advdiff(dev),
    ]
    phase_burgers_xonly(dev)
    for counts in path_counts:
        for name, c in counts.items():
            launches[name] += c
    never = [name for name, c in launches.items() if c == 0]
    if never:
        raise RuntimeError(f"chip_smoke: the main paths never launched {never}")

    print(f"[10 kernels] ms/plain_ms: the advection kernels at {N_PATH}^3 f32 (their paths' "
          f"grid), the others at {N_MAIN}^3 (512^3 bf16 for the Jacobi family)", flush=True)
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
