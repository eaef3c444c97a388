"""Poisson problem template: ``lap(phi) = rhs`` with arbitrary BCs."""
from __future__ import annotations

import torch

from pyapes_tpu_torch.mesh import Mesh
from pyapes_tpu_torch.solver.fdm import FDM
from pyapes_tpu_torch.solver.ops import Solver
from pyapes_tpu_torch.variables import Field


class PoissonSolver:
    """``lap(coeff, phi) = rhs`` (cf. demos/poisson_equations in the
    reference).

    Args:
        mesh: the mesh.
        bc_config: list of BCConfig for the domain faces.
        coeff: diffusion coefficient.
        config: FDM solver config overrides (method/tol/max_it/...).
    """

    def __init__(self, mesh: Mesh, bc_config, coeff: float = 1.0, config=None):
        self.mesh = mesh
        self.var = Field("phi", 1, mesh, {"domain": bc_config, "obstacle": None})
        self.coeff = coeff
        cfg = {
            "method": "cg",
            "tol": 1e-6,
            "max_it": 2000,
            "report": False,
            "criterion": "residual",
        }
        if mesh.obstacle is None and mesh.coord_sys == "xyz":
            # plain boxes are separable: the fast-diagonalization direct
            # solve, a non-separable equation falls back to MG-PCG; an rz
            # mesh or one with obstacles takes CG (the JAX package's choice)
            cfg.update({"method": "fastdiag", "fd_fallback": "cg", "precond": "mg"})
        cfg.update(config or {})
        self.solver = Solver({"fdm": cfg})
        self.fdm = FDM()

    def solve(self, rhs) -> Field:
        x = self.var()
        rhs = torch.as_tensor(rhs, dtype=x.dtype, device=x.device)
        if rhs.ndim == self.mesh.dim:
            rhs = rhs[None]
        self.solver.set_eq(self.fdm.laplacian(self.coeff, self.var) == rhs)
        self.report = self.solver.solve()
        return self.var
