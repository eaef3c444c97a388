"""Boussinesq natural convection: buoyancy-coupled NS + heat transport
(PyTorch port of ``pyapes_tpu/models/natural_convection.py``).

The differentially heated square cavity of de Vahl Davis (1983): hot left
wall (T = 1), cold right wall (T = 0), adiabatic others. Nondimensional
Boussinesq form (length L, time L^2/alpha):

    du/dt + (u.grad) u = -grad p + Pr lap u + Ra Pr T e_vertical
    dT/dt + (u.grad) T = lap T,   div u = 0

Validation: the hot-wall Nusselt number against the benchmark (Ra = 1e3:
1.118, Ra = 1e4: 2.243). Temperature-dependent properties: ``mu_fn``
(viscosity ``mu(T)``, re-evaluated each step from ``T^n``: the cavity's
variable-viscosity momentum) and ``k_fn`` (conductivity ``k(T)``: the heat
equation's diffusion becomes the conservative ``div(k grad T)``, a
variable-Γ term).
"""
from __future__ import annotations

import numpy as np
import torch

from pyapes_tpu_torch.geometry.basis import FDIR
from pyapes_tpu_torch.mesh import Mesh
from pyapes_tpu_torch.models.navier_stokes import LidDrivenCavity
from pyapes_tpu_torch.variables import Field

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class NaturalConvection(LidDrivenCavity):
    """Differentially heated cavity (Boussinesq); the vertical axis is the
    last mesh axis.

    Args:
        mesh: Box mesh on [0, 1]^dim.
        ra: Rayleigh number.
        pr: Prandtl number (0.71 for air, the benchmark value).
        mu_fn: ``T -> mu`` per-point viscosity, or None (the scalar Pr).
        k_fn: ``T -> k`` per-point conductivity, or None (k = 1).
    """

    def __init__(self, mesh: Mesh, ra: float = 1e3, pr: float = 0.71, config=None,
                 implicit_advection: bool = True, rhie_chow: bool = True,
                 incremental: bool = True, mu_fn=None, k_fn=None):
        # no-slip walls, no lid; viscosity = Pr in these units
        super().__init__(mesh, nu=pr, lid_velocity=0.0, config=config,
                         implicit_advection=implicit_advection, rhie_chow=rhie_chow,
                         incremental=incremental)
        self.ra = float(ra)
        self.pr = float(pr)
        self.mu_fn = mu_fn
        self.k_fn = k_fn
        t_bc = []
        for f in FDIR[: 2 * mesh.dim]:
            kind, val = {"xl": ("dirichlet", 1.0), "xu": ("dirichlet", 0.0)}.get(
                f, ("neumann", 0.0))
            t_bc.append({"bc_face": f, "bc_type": kind, "bc_val": val, "bc_val_opt": None})
        self.T = Field("T", 1, mesh, {"domain": t_bc, "obstacle": None}, init_val=0.0)
        # conduction initial state: the linear profile (faster spin-up)
        self.T.set_var_tensor((1.0 - mesh.grid[0])[None])
        self.T.apply_bcs()

    def step(self, dt: float) -> None:
        if self.mu_fn is not None:
            self.update_viscosity(self.mu_fn(self.T()[0]))
        # the buoyancy source of the vertical momentum, Ra Pr T (explicit)
        self._buoyancy = self.ra * self.pr * self.T()[0]
        super().step(dt)

        # temperature transport: implicit advection + diffusion
        T = self.T
        if T._dt is None:
            T.set_time(dt, self.t - dt)
        T.save_old()
        uvec = torch.cat([v() for v in self.vel], dim=0)
        k = 1.0 if self.k_fn is None else self._as_field(self.k_fn(T()[0]))
        self.mom_solver.set_eq(
            self.fdm.ddt(T) + self.fdm.conv(uvec, T) - self.fdm.laplacian(k, T)
            == torch.zeros_like(T())
        )
        self.mom_solver.solve()
        T.apply_bcs()
        T.update_time(dt)

    def state_fields(self) -> list:
        return super().state_fields() + [self.T]

    def _extra_momentum_rhs(self, component: int):
        if component == self.mesh.dim - 1:
            return self._buoyancy
        return 0.0

    def nusselt_avg(self) -> float:
        """Cavity-averaged Nusselt number: the mean over x of the plane
        heat flux ``Nu(x) = ∫ (u T - ∂T/∂x) dy`` (2-D only)."""
        assert self.mesh.dim == 2, "nusselt_avg: 2-D cavity diagnostic"
        T = self.T()[0].double().cpu().numpy()
        u = self.u()[0].double().cpu().numpy()
        dx = float(self.mesh.dx_np[0])
        dy = float(self.mesh.dx_np[1])
        dTdx = np.gradient(T, dx, axis=0, edge_order=2)
        return float(_trapezoid(u * T - dTdx, dx=dy, axis=1).mean())

    def nusselt_hot_wall(self) -> float:
        """Average Nusselt number on the hot (xl) wall: ``-dT/dx`` (second
        order one-sided) integrated over the wall (trapezoidal)."""
        T = self.T()[0].double().cpu().numpy()
        dx = float(self.mesh.dx_np[0])
        dTdx = (-1.5 * T[0] + 2.0 * T[1] - 0.5 * T[2]) / dx
        for j in range(1, self.mesh.dim):
            dTdx = _trapezoid(dTdx, dx=float(self.mesh.dx_np[j]), axis=0)
        return float(-dTdx)
