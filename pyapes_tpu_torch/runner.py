"""Simulation runner / CLI (port of ``pyapes_tpu/runner.py``; the
``poisson``, ``darcy``, ``burgers``, ``cavity``, ``channel``, ``convection``
and ``rfp`` subcommands: all of the JAX runner's).

    python -m pyapes_tpu_torch.runner poisson --dim 3 --n 512
    python -m pyapes_tpu_torch.runner poisson --dim 3 --n 512 --mg
    python -m pyapes_tpu_torch.runner darcy --n 1025 --avg harmonic
    python -m pyapes_tpu_torch.runner burgers --n 257 --steps 100
    python -m pyapes_tpu_torch.runner cavity --dim 3 --n 128 --re 100 --steps 5
    python -m pyapes_tpu_torch.runner channel --n 49 --steps 20 --obstacle
    python -m pyapes_tpu_torch.runner convection --n 33 --steps 60 --dt 0.0125
    python -m pyapes_tpu_torch.runner rfp --n 40 --steps 200 --refresh 20
    python -m pyapes_tpu_torch.runner poisson --dim 3 --n 17 --device cpu

Every case runs on the card unless ``--device cpu`` asks for the CPU.

``--mg`` asks for MG-preconditioned CG explicitly (``method: "cg",
precond: "mg"``); without it the separable problem takes the fastdiag
direct solve. (The JAX runner's ``--mg`` only sets ``precond`` and reaches
MG-PCG through a fault of its fastdiag probe; see ROADMAP.)

``darcy`` is the heterogeneous-permeability pressure solve (2-D,
conservative variable-Γ Laplacian, Γ-aware MG-BiCGSTAB, pressure 1 / 0 on
the x faces, zero-flux y faces); it adds the inlet/outlet fluxes, the
effective permeability and its Wiener (harmonic/arithmetic mean) bounds.

``burgers`` steps the 1-D viscous Burgers model on the periodic ``[0,
2π]`` (``nu = 0.1``, backward Euler, Picard-linearized advection, the FD
preconditioner), as the JAX runner; it adds ``steps`` and the final
time ``t``.

``cavity`` steps the lid-driven cavity (``nu = 1 / re``, unit lid, eager
steps; ``--adaptive-cfl`` integrates to ``dt * steps`` with the CFL step;
``--fused``: the whole-step runner, one CUDA graph per step on the card);
it adds ``steps``, ``t`` and the centreline minimum of u. ``channel``
steps the inflow/outflow channel ``[0, 3] x [0, 1]`` on ``n x (2n/3 + 1)``
nodes (``--obstacle``: an immersed square body ``[0.9, 1.2] x [0.35,
0.65]``) and adds the fluxes through the second and the last-but-one
cross-sections, ``max|u|`` and, with the body, its staircase drag and
lift. ``convection``
steps the de Vahl Davis cavity (2-D) and adds the hot-wall Nusselt
number. ``rfp`` relaxes an anisotropic Maxwellian on an ``n x 2n``
Cylinder velocity mesh by self-consistent RFP evolution (the potentials
re-solved every ``--refresh`` steps, explicit steps between) and adds
``steps`` and the relative ``density_drift``.

``--vtk PREFIX`` writes the final fields as a legacy-VTK file
(``utils/io.py``) for ParaView and adds its path as ``vtk``; ``--save
PATH`` checkpoints the final state of ``cavity``, ``channel``,
``convection`` and ``darcy`` to ``PATH.npz`` and ``--resume PATH``
restores ``cavity``, ``channel`` and ``convection`` from one before
stepping (``utils/checkpoint.py``; with ``--fused`` the state is loaded
before the first capture), as the JAX runner does.

Each prints one JSON line ``{"report": {...}, "wall_s": ..., "n": ...}``,
the JAX runner's shape. ``wall_s`` is the host wall time of the solve, ending
after the solution is on the device (the solve reads its tolerance back
every pass, and the runner synchronises before stopping the clock).
"""
from __future__ import annotations

import argparse
import json
import time


def _maybe_resume(args, model, fields) -> None:
    if args.resume:
        from pyapes_tpu_torch.utils.checkpoint import load

        load(args.resume, fields)
        # continue from the checkpointed simulation time
        model.t = max(float(f._t) for f in fields)


def _maybe_save(args, fields) -> None:
    if args.save:
        from pyapes_tpu_torch.utils.checkpoint import save

        save(args.save, fields)


def _maybe_vtk(args, mesh, fields: dict) -> dict:
    if not args.vtk:
        return {}
    from pyapes_tpu_torch.utils.io import write_vtk

    return {"vtk": write_vtk(args.vtk, mesh, fields)}


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
    out = {"report": dict(model.report), "wall_s": wall, "n": args.n}
    out.update(_maybe_vtk(args, mesh, {"p": model.var()[0]}))
    return out


def _run_darcy(args) -> dict:
    import numpy as np
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.testing.darcy import inlet_outlet_flux, log_normal_permeability
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import mixed_bcs

    n = args.n
    mesh = Mesh(Box[0:1, 0:1], None, [n, n], device=args.device, dtype=args.dtype)
    K = log_normal_permeability(mesh, seed=args.seed, contrast=args.contrast)
    bcs = mixed_bcs([1.0, 0.0, 0.0, 0.0], ["dirichlet", "dirichlet", "neumann", "neumann"])
    pf = Field("p", 1, mesh, {"domain": bcs}, init_val=0.0)
    solver = Solver({"fdm": {"method": "bicgstab", "tol": args.tol, "max_it": args.max_it,
                             "report": False, "criterion": "residual", "precond": "mg"}})
    fdm = FDM()
    tic = time.perf_counter()
    solver.set_eq(fdm.laplacian(K, pf, avg=args.avg) == 0.0)
    rep = solver.solve()
    if mesh.is_cuda:
        torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - tic

    ph = pf()[0].double().cpu().numpy()
    q_in, q_out = inlet_outlet_flux(K, ph, mesh)
    out = {
        "report": dict(rep),
        "wall_s": wall,
        "n": n,
        "flux_in": q_in,
        "flux_out": q_out,
        "k_eff": 0.5 * (q_in + q_out),
        "k_harmonic": float(1.0 / np.mean(1.0 / K)),
        "k_arithmetic": float(np.mean(K)),
    }
    out.update(_maybe_vtk(args, mesh, {"p": ph, "K": K}))
    _maybe_save(args, [pf])
    return out


def _run_burgers(args) -> dict:
    from math import pi

    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import Burgers1D

    mesh = Mesh(Box[0 : 2 * pi], None, [args.n], device=args.device, dtype=args.dtype)
    model = Burgers1D(mesh, nu=0.1)
    tic = time.perf_counter()
    for _ in range(args.steps):
        model.step(args.dt)
    if mesh.is_cuda:
        torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - tic
    out = {"wall_s": wall, "steps": args.steps, "t": model.var.t}
    out.update(_maybe_vtk(args, mesh, {"u": model.var()[0]}))
    return out


def _run_cavity(args) -> dict:
    import numpy as np
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import LidDrivenCavity

    box = Box[tuple(slice(0, 1) for _ in range(args.dim))]
    mesh = Mesh(box, None, [args.n] * args.dim, device=args.device, dtype=args.dtype)
    model = LidDrivenCavity(mesh, nu=1.0 / args.re, lid_velocity=1.0,
                            implicit_advection=args.implicit_advection)
    _maybe_resume(args, model, model.vel + [model.p])
    tic = time.perf_counter()
    if args.adaptive_cfl:
        n_steps = model.run_adaptive(args.adaptive_cfl, t_end=args.dt * args.steps)
    else:
        n_steps = args.steps
        model.run(dt=args.dt, n_steps=args.steps, fused=args.fused)
    if mesh.is_cuda:
        torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - tic
    _maybe_save(args, model.vel + [model.p])
    u = model.u()[0].double().cpu().numpy()
    mid = (u.shape[0] // 2,) * (args.dim - 1)
    out = {"wall_s": wall, "steps": n_steps, "u_centerline_min": float(np.min(u[mid])),
           "t": float(model.t)}
    fields = {v.name: v()[0] for v in model.vel}
    fields["p"] = model.p()[0]
    out.update(_maybe_vtk(args, mesh, fields))
    return out


def _run_channel(args) -> dict:
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import ChannelFlow

    obs = [Box[0.9:1.2, 0.35:0.65]] if args.obstacle else None
    mesh = Mesh(Box[0:3, 0:1], obs, [args.n, (args.n * 2) // 3 + 1], device=args.device,
                dtype=args.dtype)
    model = ChannelFlow(mesh, nu=args.nu, u_in=1.0)
    _maybe_resume(args, model, model.vel + [model.p])
    tic = time.perf_counter()
    model.run(dt=args.dt, n_steps=args.steps)
    if mesh.is_cuda:
        torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - tic
    _maybe_save(args, model.vel + [model.p])
    n0 = mesh.nx[0]
    out = {"wall_s": wall, "steps": args.steps, "flux_in": model.flux(1),
           "flux_out": model.flux(n0 - 2), "u_max": float(model.u().abs().max())}
    if args.obstacle:
        drag, lift = model.body_force()
        out["drag"] = float(drag)
        out["lift"] = float(lift)
    out.update(_maybe_vtk(args, mesh, {"u": model.u()[0], "v": model.v()[0],
                                       "p": model.p()[0]}))
    return out


def _run_convection(args) -> dict:
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import NaturalConvection

    mesh = Mesh(Box[0:1, 0:1], None, [args.n, args.n], device=args.device, dtype=args.dtype)
    model = NaturalConvection(mesh, ra=args.ra, pr=args.pr)
    _maybe_resume(args, model, model.vel + [model.p, model.T])
    tic = time.perf_counter()
    model.run(dt=args.dt, n_steps=args.steps, fused=args.fused)
    if mesh.is_cuda:
        torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - tic
    _maybe_save(args, model.vel + [model.p, model.T])
    out = {"wall_s": wall, "steps": args.steps, "t": float(model.t),
           "nusselt_hot_wall": model.nusselt_hot_wall()}
    fields = {v.name: v()[0] for v in model.vel}
    fields["p"] = model.p()[0]
    fields["T"] = model.T()[0]
    out.update(_maybe_vtk(args, mesh, fields))
    return out


def _run_rfp(args) -> dict:
    import numpy as np
    import torch

    from pyapes_tpu_torch.geometry import Cylinder
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import RFPEvolution
    from pyapes_tpu_torch.variables import Field

    L = args.vmax
    mesh = Mesh(Cylinder[0:L, -L:L], None, [args.n, 2 * args.n], device=args.device,
                dtype=args.dtype)
    R, Z = np.asarray(mesh._grid_np[0]), np.asarray(mesh._grid_np[1])
    f0 = np.exp(-(R**2) / (2 * args.t_perp) - Z**2 / (2 * args.t_par))
    f = Field("pdf", 1, mesh, None)
    f.set_var_tensor(f0)
    den0 = float(f.volume_integral()[0])

    model = RFPEvolution(mesh)
    tic = time.perf_counter()
    f = model.run_selfconsistent(f, dt=args.dt, n_steps=args.steps, refresh_every=args.refresh)
    if mesh.is_cuda:
        torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - tic
    den1 = float(f.volume_integral()[0])
    out = {"wall_s": wall, "steps": args.steps, "density_drift": abs(den1 - den0) / den0}
    out.update(_maybe_vtk(args, mesh, {"pdf": f()[0]}))
    return out


def run(argv=None) -> dict:
    """Parse the command line ``argv`` and run its case; returns the
    JSON-able result that ``main`` prints."""
    p = argparse.ArgumentParser(prog="pyapes_tpu_torch.runner")
    sub = p.add_subparsers(dest="case", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--n", type=int, default=65)
    common.add_argument("--dtype", default="single")
    common.add_argument("--tol", type=float, default=1e-6)
    common.add_argument("--max-it", type=int, default=2000)
    common.add_argument(
        "--device", default="cuda", choices=["cpu", "cuda", "gpu"],
        help="torch device (default cuda; raises when no CUDA device is present)",
    )
    common.add_argument("--vtk", default=None, metavar="PREFIX",
                        help="write final fields as legacy VTK (ParaView)")
    common.add_argument("--save", default=None, metavar="PATH",
                        help="checkpoint final field state to PATH.npz")
    common.add_argument("--resume", default=None, metavar="PATH",
                        help="restore field state from PATH.npz before stepping")

    sp = sub.add_parser("poisson", parents=[common])
    sp.add_argument("--dim", type=int, default=2, choices=[1, 2, 3])
    sp.add_argument("--mg", action="store_true", help="MG-preconditioned CG")

    sd = sub.add_parser("darcy", parents=[common])
    sd.add_argument("--seed", type=int, default=7)
    sd.add_argument("--contrast", type=float, default=-2.5,
                    help="log-permeability of the inclusions")
    sd.add_argument("--avg", default="arithmetic", choices=["arithmetic", "harmonic"],
                    help="face-transmissibility rule")

    sb = sub.add_parser("burgers", parents=[common])
    sb.add_argument("--dt", type=float, default=0.01)
    sb.add_argument("--steps", type=int, default=100)

    sc = sub.add_parser("cavity", parents=[common])
    sc.add_argument("--re", type=float, default=100.0)
    sc.add_argument("--dt", type=float, default=0.01)
    sc.add_argument("--steps", type=int, default=500)
    sc.add_argument("--dim", type=int, default=2, choices=[2, 3])
    sc.add_argument("--implicit-advection", action="store_true")
    sc.add_argument("--adaptive-cfl", type=float, default=None, metavar="CFL",
                    help="CFL-adaptive dt (integrates to t_end = dt * steps)")
    sc.add_argument("--fused", action="store_true",
                    help="whole-step runner: one CUDA graph per step on the card")

    sch = sub.add_parser("channel", parents=[common])
    sch.add_argument("--nu", type=float, default=0.05)
    sch.add_argument("--dt", type=float, default=0.005)
    sch.add_argument("--steps", type=int, default=400)
    sch.add_argument("--obstacle", action="store_true",
                     help="immersed square body in the channel")

    sv = sub.add_parser("convection", parents=[common])
    sv.add_argument("--ra", type=float, default=1e3)
    sv.add_argument("--pr", type=float, default=0.71)
    sv.add_argument("--dt", type=float, default=0.01)
    sv.add_argument("--steps", type=int, default=100)
    sv.add_argument("--fused", action="store_true",
                    help="whole-step runner: one CUDA graph per step on the card")

    sr = sub.add_parser("rfp", parents=[common])
    sr.add_argument("--dt", type=float, default=2e-4)
    sr.add_argument("--steps", type=int, default=100)
    sr.add_argument("--refresh", type=int, default=20)
    sr.add_argument("--vmax", type=float, default=4.5)
    sr.add_argument("--t-perp", type=float, default=0.36)
    sr.add_argument("--t-par", type=float, default=1.0)

    args = p.parse_args(argv)
    return {"poisson": _run_poisson, "darcy": _run_darcy, "burgers": _run_burgers,
            "cavity": _run_cavity, "channel": _run_channel, "convection": _run_convection,
            "rfp": _run_rfp}[args.case](args)


def main(argv=None) -> None:
    print(json.dumps(run(argv)))


if __name__ == "__main__":
    main()
