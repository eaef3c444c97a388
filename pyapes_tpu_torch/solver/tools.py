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
    """"mg" (geometric multigrid V-cycle, ``solver/multigrid.py``) or None,
    for cg/bicgstab; ignored by fastdiag (a direct solver), as in the JAX
    package. "fd" is ported in a later slice and raises."""
    fd_opts: dict
    """Fast-diagonalization options: {"precision": "highest"} (true-f32
    transforms, the only setting ported)."""
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
    """Accepted for the JAX package's configs: the port's loops never write
    the caller's initial guess, so there is nothing to donate."""
    nullspace: str
    """"mean" solves singular all-Neumann systems on the zero-mean
    quotient space (compatibility-projected RHS)."""
    history: bool
    """Record the per-iteration convergence measure in the report."""
    decomp: DomainDecomposition
    """Domain decomposition (``pyapes_tpu_torch.parallel``): the axis and
    advection operators apply block by block with a halo exchange, the MG
    levels too; every block on the solve's device. Anything else (e.g. a
    dict) raises ``TypeError``; a block on another device raises
    ``NotImplementedError``."""


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
