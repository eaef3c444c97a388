"""Solver tools: configuration types and default coefficient banks
(reference ``pyapes/solver/tools.py``).

The full-grid 5-bank layout ``[App, Ap, Ac, Am, Amm]`` is kept for the
explicit FDC path and parity tests; the implicit solver uses the per-axis
vectors of ``pyapes_tpu_torch.ops.stencil`` instead.
"""
from __future__ import annotations

from typing import TypedDict

import torch

from pyapes_tpu_torch.parallel.decomp import DomainDecomposition
from pyapes_tpu_torch.variables import Field


class FDMSolverConfig(TypedDict, total=False):
    method: str
    """"fastdiag" (direct fast-diagonalization solve for separable
    laplacian operators, ``solver/fastdiag.py``), "cg" (symmetric systems)
    or "bicgstab" (nonsymmetric systems)."""
    tol: float
    max_it: int
    report: bool
    criterion: str
    """"delta" or "residual"; fastdiag always reports the true relative
    residual."""
    precond: str
    """"mg" (geometric multigrid V-cycle, ``solver/multigrid.py``), "fd"
    (the fast-diagonalization preconditioner, ``solver/fastdiag.py``) or
    None, for cg/bicgstab; ignored by fastdiag (a direct solver), as in the
    JAX package."""
    fd_opts: dict
    """Fast-diagonalization options, for method "fastdiag" and precond "fd":
    {"precision": "highest" (true-f32 transforms, the default) or "default"
    (the transforms' GEMMs in TF32 on the card, the TF32 flags set only
    around them and restored after, an exception included; on the CPU the
    bits of "highest"), "dtype": the factors' dtype, e.g. "bfloat16" (each
    transform stage a product in it accumulated in f32, the result in the
    solve's dtype)}. Both enter the factors' cache key. Anything else
    raises ValueError."""
    kernel: str
    """"auto" (default) or "pallas": the same path, the hand-written
    kernels on a CUDA tensor, their plain versions on a CPU one (the
    counterpart of Pallas interpret mode). "jnp" (the JAX package's
    plain-jnp tier) raises NotImplementedError: the port has no plain tier
    on the card."""
    debug: str
    """"nan": the solve's loop runs on the host under ``utils.debug``'s NaN
    check (every PyTorch operator and every hand kernel's output) and
    raises ``NaNError`` naming the first operation whose output holds a
    NaN, before the end-of-solve "Invalid tolerance" check; a clean solve
    gives the unchecked bits and ``itr``. Inside a fused whole step it
    raises ValueError, as the JAX package's fused capture does."""
    fd_fallback: str
    """With method "fastdiag": the Krylov method to use when the equation
    is NOT separable."""
    mg_opts: dict
    """Multigrid knobs: {"dtype" (cycle dtype, e.g. "bfloat16"; the Krylov
    loop keeps the solve's dtype), "n_pre", "n_post", "n_coarse", "omega",
    "smoother" ("jacobi" | "rbgs" | "chebyshev"), "fmg" (full-multigrid
    initial guess), "fmg_cycles", "fuse_rz" (PCG dot(r, z) inside the last
    smooth), "transfers" ("strided" | "matrix")}. Ignored by fastdiag."""
    donate: bool
    """True: the solve writes its solution into the storage of the initial
    guess ``var()`` (the loop's iterate lives there), so the peak holds one
    grid fewer (0.5 GiB at 512^3 f32); opt-in, as in the JAX package. The
    caller must not donate where the field's old-time history
    (``save_old``: ``VARo`` is the pre-solve ``VAR``) or a constructed
    field's ``VARo`` still aliases that tensor and is read later: it then
    holds the solution. No grid is saved, and the guess is left as it was,
    on periodic axes (the loop runs on the reduced torus, a strided view,
    and the seam is re-appended into a new tensor), for a ``sync: False``
    solve replayed from a graph (it works in the graph's buffers) and
    inside a fused whole step; a decomposition saves it as any solve."""
    nullspace: str
    """"mean" solves singular all-Neumann systems on the zero-mean
    quotient space (compatibility-projected RHS)."""
    history: bool
    """Record the per-iteration convergence measure in the report."""
    decomp: DomainDecomposition
    """Domain decomposition (``pyapes_tpu_torch.parallel``): the axis and
    advection operators apply block by block with a halo exchange, the MG
    levels too; with ``devices`` (placed) each block of the loop vectors
    lives on its own device, for CG and BiCGSTAB (plain or with
    ``precond: "mg"``); other options raise ``NotImplementedError`` there.
    Anything else than a ``DomainDecomposition`` (e.g. a dict) raises
    ``TypeError``; a device the machine lacks raises ``ValueError``."""


class SolverConfig(TypedDict, total=False):
    fdm: FDMSolverConfig


def default_A_ops(var: Field, ops: str) -> list[list[torch.Tensor]]:
    """Second-order central-difference coefficient banks (reference
    ``tools.py:29-112``); in rz the axis-0 banks carry the geometric terms
    (Div: ``2 dr / r`` in the centre; Laplacian: ``1 +- dr / (2 r)``),
    zero at r = 0.

    Returns five banks ``[App, Ap, Ac, Am, Amm]`` for offsets
    ``i+2, i+1, i, i-1, i-2``; each bank is a list over ``mesh.dim`` of
    tensors shaped ``(var.dim, *mesh.nx)``.
    """
    mesh = var.mesh
    md = mesh.dim
    shape = (var.dim, *mesh.nx)
    ones = torch.ones(shape, dtype=mesh.dtype.float, device=mesh.device)
    zeros = torch.zeros_like(ones)
    rz = mesh.coord_sys == "rz"

    op = ops.lower()
    App = [zeros for _ in range(md)]
    Amm = [zeros for _ in range(md)]
    if op == "grad" or (op == "div" and not rz):
        Ap = [ones for _ in range(md)]
        Ac = [zeros for _ in range(md)]
        Am = [-ones for _ in range(md)]
    elif op == "div":
        scale = torch.nan_to_num(2 * float(mesh.dx_np[0]) / mesh.R, nan=0.0, posinf=0.0,
                                neginf=0.0)
        Ap = [ones for _ in range(md)]
        Ac = [scale * ones if i == 0 else zeros for i in range(md)]
        Am = [-ones for _ in range(md)]
    elif op == "laplacian" and not rz:
        Ap = [ones for _ in range(md)]
        Ac = [-2.0 * ones for _ in range(md)]
        Am = [ones for _ in range(md)]
    elif op == "laplacian":
        scale = torch.nan_to_num(float(mesh.dx_np[0]) / (2 * mesh.R), nan=0.0, posinf=0.0,
                                neginf=0.0)
        Ap = [(1 + scale) * ones if i == 0 else ones for i in range(md)]
        Ac = [-2.0 * ones for _ in range(md)]
        Am = [(1 - scale) * ones if i == 0 else ones for i in range(md)]
    else:
        raise RuntimeError(f"Given {ops=} should be either grad, div, or laplacian.")

    return [App, Ap, Ac, Am, Amm]
