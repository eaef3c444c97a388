"""Advection-diffusion template, steady and transient (port of
``pyapes_tpu/models/advection_diffusion.py``)."""
from __future__ import annotations

from pyapes_tpu_torch.mesh import Mesh
from pyapes_tpu_torch.solver.fdm import FDM
from pyapes_tpu_torch.solver.ops import Solver
from pyapes_tpu_torch.variables import Field


class AdvectionDiffusion:
    """``ddt(phi) + div(u, phi) - lap(eps, phi) = rhs`` (transient) or the
    steady version without ``ddt``.

    Args:
        mesh: the mesh.
        bc_config: domain BC list.
        velocity: advecting velocity: a float (the axis stencil; QUICK's
            5-point one with ``limiter="quick"``), or a ``(1, *nx)`` array
            or Field (the per-point ``div_field`` term).
        epsilon: diffusivity.
        limiter: "none" (central), "upwind" or "quick".
        config: FDM solver config overrides.
    """

    def __init__(self, mesh: Mesh, bc_config, velocity=1.0, epsilon: float = 0.1,
                 limiter: str = "upwind", init_val=0.0, config=None):
        self.mesh = mesh
        self.var = Field("phi", 1, mesh, {"domain": bc_config, "obstacle": None},
                         init_val=init_val)
        self.velocity = velocity
        self.epsilon = epsilon
        cfg = {"method": "bicgstab", "tol": 1e-6, "max_it": 2000, "report": False}
        if mesh.obstacle is None and not any(k in (config or {}) for k in ("method", "precond")):
            # FD preconditioner from the separable part: a CONSTANT velocity
            # sums its axis matrices into the diffusion ones (near-direct);
            # a velocity FIELD leaves a frozen diffusion+dt preconditioner;
            # fd_fallback degrades to plain BiCGSTAB where FD setup is
            # impossible (QUICK's 5-point axes)
            cfg.update({"precond": "fd", "fd_fallback": "bicgstab"})
        cfg.update(config or {})
        self.solver = Solver({"fdm": cfg})
        self.fdm = FDM({"div": {"limiter": limiter, "edge": False}})

    def solve_steady(self, rhs=0.0) -> Field:
        eq = self.fdm.div(self.velocity, self.var) - self.fdm.laplacian(self.epsilon, self.var)
        self.solver.set_eq(eq == rhs)
        self.report = self.solver.solve()
        return self.var

    def step(self, dt: float, rhs=0.0) -> Field:
        """One implicit (backward Euler) transient step."""
        if self.var._dt is None:
            self.var.set_time(dt, 0.0)
        self.var.save_old()
        eq = (
            self.fdm.ddt(self.var)
            + self.fdm.div(self.velocity, self.var)
            - self.fdm.laplacian(self.epsilon, self.var)
        )
        self.solver.set_eq(eq == rhs)
        self.report = self.solver.solve()
        self.var.update_time(dt)
        return self.var
