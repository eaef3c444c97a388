"""Viscous Burgers templates (port of ``pyapes_tpu/models/burgers.py``)."""
from __future__ import annotations

import torch

from pyapes_tpu_torch.mesh import Mesh
from pyapes_tpu_torch.solver.fdm import FDM
from pyapes_tpu_torch.solver.ops import Solver
from pyapes_tpu_torch.testing.burgers import burger_exact_nd
from pyapes_tpu_torch.variables import Field
from pyapes_tpu_torch.variables.bcs import homogeneous_bcs


def _config(mesh: Mesh, config) -> dict:
    """BiCGSTAB to 1e-8 with two Picard sweeps; unless the caller picks a
    method or preconditioner, the frozen diffusion+dt FD preconditioner
    (the nonlinear advection is left out of it; ``fd_fallback`` degrades to
    plain BiCGSTAB where FD setup is impossible)."""
    cfg = {"method": "bicgstab", "tol": 1e-8, "max_it": 2000, "report": False, "picard": 2}
    if mesh.obstacle is None and not any(k in (config or {}) for k in ("method", "precond")):
        cfg.update({"precond": "fd", "fd_fallback": "bicgstab"})
    cfg.update(config or {})
    return cfg


class Burgers1D:
    """``ddt(u) + u u_x = nu u_xx`` on a periodic domain, backward Euler +
    the Picard-linearized advective-form Div."""

    def __init__(self, mesh: Mesh, nu: float = 0.1, init_val=None, config=None):
        assert mesh.dim == 1
        self.mesh = mesh
        self.nu = nu
        if init_val is None:
            init_val = [burger_exact_nd(mesh, nu, 0.0)]
        self.var = Field("U", 1, mesh, {"domain": homogeneous_bcs(1, None, "periodic"),
                                        "obstacle": None}, init_val=init_val)
        self.solver = Solver({"fdm": _config(mesh, config)})
        self.fdm = FDM({"div": {"limiter": "none", "edge": False, "form": "advective"}})

    def step(self, dt: float) -> Field:
        if self.var._dt is None:
            self.var.set_time(dt, 0.0)
        self.var.save_old()
        self.solver.set_eq(
            self.fdm.ddt(self.var)
            + self.fdm.div(self.var, self.var)
            - self.fdm.laplacian(self.nu, self.var)
            == 0.0
        )
        self.report = self.solver.solve()
        self.var.update_time(dt)
        return self.var


class BurgersND:
    """N-D viscous Burgers system on a periodic box,
    ``du_i/dt + u_j d(u_i)/dx_j = nu lap u_i``: each component solves
    implicitly with ``fdm.conv`` against the previous step's velocity (the
    ``conv_field`` term; the Hopper convection kernel on the card).

    Args:
        mesh: periodic Box mesh (2-D or 3-D).
        nu: viscosity.
        init_vals: ``(1, *nx)`` initial arrays, one per component (default
            zero).
    """

    def __init__(self, mesh: Mesh, nu: float = 0.1, init_vals=None, config=None):
        assert mesh.dim in (2, 3)
        self.mesh = mesh
        self.nu = nu
        f_bc = homogeneous_bcs(mesh.dim, None, "periodic")
        self.vel = [Field(nm, 1, mesh, {"domain": f_bc, "obstacle": None}, init_val=0.0)
                    for nm in ("u", "v", "w")[: mesh.dim]]
        if init_vals is not None:
            for var, iv in zip(self.vel, init_vals):
                var.set_var_tensor(iv)
        self.solver = Solver({"fdm": _config(mesh, config)})
        self.fdm = FDM({"div": {"limiter": "none", "edge": False}})
        self.t = 0.0

    def step(self, dt: float) -> None:
        for var in self.vel:
            if var._dt is None:
                var.set_time(dt, self.t)
            var.save_old()
        uvec = torch.cat([v() for v in self.vel], dim=0)
        for var in self.vel:
            self.solver.set_eq(
                self.fdm.ddt(var)
                + self.fdm.conv(uvec, var)
                - self.fdm.laplacian(self.nu, var)
                == torch.zeros_like(var())
            )
            self.report = self.solver.solve()
            var.update_time(dt)
        self.t += dt

    def run(self, dt: float, n_steps: int) -> None:
        for _ in range(n_steps):
            self.step(dt)
