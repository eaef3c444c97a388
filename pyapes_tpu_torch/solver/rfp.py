"""Discretizations of the Rosenbluth–Fokker–Planck equation, rz only
(PyTorch port of ``pyapes_tpu/solver/rfp.py``).

Conservative face-flux operators built from ``torch.roll`` shifts, in
plain PyTorch: the JAX package computes them with ``jnp.roll`` sums
outside any Pallas kernel, so the port has no kernel for them. The
boundary rows (zero normal flux at r = 0 / R, z = 0 / Z) are overwritten
term for term as in the JAX package, and the r = 0 divisions are cleaned
with ``nan_to_num`` where it cleans them.

The grid spacings enter as Python floats (``mesh.dx_np``), so an operator
call uploads nothing from the host.
"""
from __future__ import annotations

import numpy as np
import torch

from pyapes_tpu_torch.variables import Field
from pyapes_tpu_torch.variables.container import Hess, Jac


def _nan0(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


class Friction:
    """Divergence of the drift flux ``grad(H) f`` by face-averaged products
    with r-weighting (reference ``rfp.py:12-82``); rz only."""

    @staticmethod
    def __call__(jacH: Jac, var: Field) -> torch.Tensor:
        if var.mesh.coord_sys != "rz":
            raise NotImplementedError("FP: Friction is only implemented for rz coordinate system.")
        return friction_apply(jacH.r, jacH.z, var()[0], var.mesh)


def friction_apply(Hr, Hz, pdf, mesh) -> torch.Tensor:
    """Tensor-level friction operator (pure; linear in ``pdf``, so usable
    as an ``fdm.custom`` term)."""
    dr, dz = (float(d) for d in mesh.dx_np)
    R = mesh.R

    Arp = (torch.roll(Hr, -1, 0) + Hr) / 2.0
    Arm = (Hr + torch.roll(Hr, 1, 0)) / 2.0
    Azp = (torch.roll(Hz, -1, 1) + Hz) / 2.0
    Azm = (Hz + torch.roll(Hz, 1, 1)) / 2.0

    Prp = (torch.roll(pdf, -1, 0) + pdf) / 2.0
    Prm = (pdf + torch.roll(pdf, 1, 0)) / 2.0
    Pzp = (torch.roll(pdf, -1, 1) + pdf) / 2.0
    Pzm = (pdf + torch.roll(pdf, 1, 1)) / 2.0

    r_p = (torch.roll(R, -1, 0) + R) / 2
    r_m = (R + torch.roll(R, 1, 0)) / 2

    z_flux = (Azp * Pzp - Azm * Pzm) / dz
    r_raw = (r_p * Arp * Prp - r_m * Arm * Prm) / (R * dr)
    r_flux = _nan0(r_raw)

    friction = z_flux + r_raw

    # BC: zero normal flux (reference ``rfp.py:52-80``)
    friction[0, :] = z_flux[0, :]  # r = 0: Arm = 0
    friction[-1, :] = z_flux[-1, :] + 2.0 * ((-r_m * Arm * Prm) / (R * dr))[-1, :]  # r = R
    friction[:, 0] = 2.0 * (Azp * Pzp)[:, 0] / dz + r_flux[:, 0]  # z = 0
    friction[:, -1] = 2.0 * (-Azm * Pzm)[:, -1] / dz + r_flux[:, -1]  # z = Z
    return friction


class Diffusion:
    r"""Divergence of an anisotropic diffusion tensor,
    :math:`\nabla \cdot (\mathbf{D} \cdot \nabla \Phi)`, by the symmetric
    face-flux discretization with bilinear corner interpolation of
    ``D_rz`` (reference ``rfp.py:85-219``); rz only."""

    @staticmethod
    def __call__(hessG: Hess, var: Field) -> torch.Tensor:
        if var.mesh.coord_sys != "rz":
            raise NotImplementedError("FP: Diffusion is only implemented for rz coordinate system.")
        return diffusion_apply(hessG.rr, hessG.rz, hessG.zz, var()[0], var.mesh)


def diffusion_apply(Drr, Drz, Dzz, pdf, mesh) -> torch.Tensor:
    """Tensor-level anisotropic-diffusion operator (pure; linear in
    ``pdf``)."""
    dr, dz = (float(d) for d in mesh.dx_np)
    R = mesh.grid[0]

    Drr_Pr_rpz = (torch.roll(Drr, -1, 0) + Drr) * (torch.roll(pdf, -1, 0) - pdf) / (2.0 * dr)
    Drr_Pr_rmz = (torch.roll(Drr, 1, 0) + Drr) * (pdf - torch.roll(pdf, 1, 0)) / (2.0 * dr)
    Dzz_Pz_rzp = (torch.roll(Dzz, -1, 1) + Dzz) * (torch.roll(pdf, -1, 1) - pdf) / (2.0 * dz)
    Dzz_Pz_rzm = (torch.roll(Dzz, 1, 1) + Dzz) * (pdf - torch.roll(pdf, 1, 1)) / (2.0 * dz)

    Drz_pp = _c_interp(Drz, 1, 1)
    Drz_pm = _c_interp(Drz, 1, 0)
    Drz_mp = _c_interp(Drz, 0, 1)
    Drz_mm = _c_interp(Drz, 0, 0)

    Drz_Pr_rzp = 0.25 * Drz_pp * (
        _flux(pdf, (1, 0), (0, 0), dr) + _flux(pdf, (1, 1), (0, 1), dr)
    ) + 0.25 * Drz_mp * (
        _flux(pdf, (0, 0), (-1, 0), dr) + _flux(pdf, (0, 1), (-1, 1), dr)
    )
    Drz_Pr_rzm = 0.25 * Drz_pm * (
        _flux(pdf, (1, -1), (0, -1), dr) + _flux(pdf, (1, 0), (0, 0), dr)
    ) + 0.25 * Drz_mm * (
        _flux(pdf, (0, -1), (-1, -1), dr) + _flux(pdf, (0, 0), (-1, 0), dr)
    )
    Drz_Pz_rpz = 0.25 * Drz_pp * (
        _flux(pdf, (0, 1), (0, 0), dz) + _flux(pdf, (1, 1), (1, 0), dz)
    ) + 0.25 * Drz_mp * (
        _flux(pdf, (0, 0), (0, -1), dz) + _flux(pdf, (1, 0), (1, -1), dz)
    )
    Drz_Pz_rmz = 0.25 * Drz_pm * (
        _flux(pdf, (-1, 1), (-1, 0), dz) + _flux(pdf, (0, 1), (0, 0), dz)
    ) + 0.25 * Drz_mm * (
        _flux(pdf, (-1, 0), (-1, -1), dz) + _flux(pdf, (0, 0), (0, -1), dz)
    )

    r_p = (torch.roll(R, -1, 0) + R) / 2
    r_m = (R + torch.roll(R, 1, 0)) / 2

    z_part = (Dzz_Pz_rzp - Dzz_Pz_rzm) / dz + (Drz_Pr_rzp - Drz_Pr_rzm) / dz
    r_part_raw = (r_p * Drz_Pz_rpz - r_m * Drz_Pz_rmz) / (R * dr) + (
        r_p * Drr_Pr_rpz - r_m * Drr_Pr_rmz
    ) / (R * dr)
    r_part = _nan0(r_part_raw)

    diffusion = z_part + r_part_raw

    # boundary rows (reference ``rfp.py:178-217``)
    diffusion[0, :] = (  # r = 0
        (Dzz_Pz_rzp - Dzz_Pz_rzm)[0, :] / dz + 2.0 * (Drz_Pr_rzp - Drz_Pr_rzm)[0, :] / dz
    )
    diffusion[-1, :] = (  # r = R
        z_part[-1, :]
        + 2.0 * ((-r_m * Drz_Pz_rmz) / (R * dr))[-1, :]
        + 2.0 * ((-r_m * Drr_Pr_rmz) / (R * dr))[-1, :]
    )
    diffusion[:, 0] = (  # z = 0
        2.0 * ((Dzz_Pz_rzp) / dz + (Drz_Pr_rzp) / dz)[:, 0] + r_part[:, 0]
    )
    diffusion[:, -1] = (  # z = Z
        2.0 * ((-Dzz_Pz_rzm) / dz + (-Drz_Pr_rzm) / dz)[:, -1] + r_part[:, -1]
    )
    return diffusion


def _flux(var: torch.Tensor, idx_p, idx_m, dx: float) -> torch.Tensor:
    """Gradient at the cell surface (reference ``rfp.py:222-230``)."""
    ip = (-idx_p[0], -idx_p[1])
    im = (-idx_m[0], -idx_m[1])
    return (torch.roll(var, ip, (0, 1)) - torch.roll(var, im, (0, 1))) / dx


def _c_interp(var: torch.Tensor, upper_i: int, upper_j: int) -> torch.Tensor:
    """Bilinear interpolation to the cell corner (reference ``rfp.py:233-250``)."""
    return (
        torch.roll(var, (-upper_i, -upper_j), (0, 1))
        + torch.roll(var, (-upper_i, -upper_j + 1), (0, 1))
        + torch.roll(var, (-upper_i + 1, -upper_j), (0, 1))
        + torch.roll(var, (-upper_i + 1, -upper_j + 1), (0, 1))
    ) / 4


class RFP:
    """Fokker–Planck operator facade (reference ``rfp.py:253-257``); the
    operators return tensors, not Fields."""

    friction: Friction = Friction()
    diffusion: Diffusion = Diffusion()


def _muscl_face_states(pdf, axis, lim):
    """Second-order TVD face reconstruction along ``axis``: limited cell
    slopes (``lim`` = ``mc_limiter`` | ``minmod``), left/right states at
    face i+1/2; the boundary cells' slopes are zero (first order at the
    walls: the wrap rows of ``torch.roll`` must not leak across)."""
    dm = pdf - torch.roll(pdf, 1, axis)
    dp = torch.roll(pdf, -1, axis) - pdf
    s = lim(dm, dp)
    edge = [slice(None)] * pdf.ndim
    edge[axis] = 0
    s[tuple(edge)] = 0.0
    edge[axis] = -1
    s[tuple(edge)] = 0.0
    pL = pdf + 0.5 * s
    pR = torch.roll(pdf, -1, axis) - 0.5 * torch.roll(s, -1, axis)
    return pL, pR


def friction_apply_muscl(Hr, Hz, pdf, mesh, limiter: str = "mc"):
    """MUSCL/TVD variant of ``friction_apply``: the face value of f is a
    limited second-order upwind reconstruction instead of the central
    average (positivity-preserving transport for sharp distributions).
    The face drift velocities, the r-weighting and the zero-flux boundary
    rows are ``friction_apply``'s."""
    lim = mc_limiter if limiter == "mc" else minmod
    dr, dz = (float(d) for d in mesh.dx_np)
    R = mesh.R

    # face drift velocities at i+1/2 (r) and j+1/2 (z)
    Ar = (torch.roll(Hr, -1, 0) + Hr) / 2.0
    Az = (torch.roll(Hz, -1, 1) + Hz) / 2.0

    pLr, pRr = _muscl_face_states(pdf, 0, lim)
    pLz, pRz = _muscl_face_states(pdf, 1, lim)
    # upwind flux F = a+ pL + a- pR at each face
    Fr = torch.clamp(Ar, min=0.0) * pLr + torch.clamp(Ar, max=0.0) * pRr
    Fz = torch.clamp(Az, min=0.0) * pLz + torch.clamp(Az, max=0.0) * pRz

    r_p = (torch.roll(R, -1, 0) + R) / 2
    r_m = (R + torch.roll(R, 1, 0)) / 2

    Frm = torch.roll(Fr, 1, 0)  # flux at i-1/2
    Fzm = torch.roll(Fz, 1, 1)  # flux at j-1/2

    z_flux = (Fz - Fzm) / dz
    r_flux_raw = (r_p * Fr - r_m * Frm) / (R * dr)
    r_flux = _nan0(r_flux_raw)

    out = z_flux + r_flux_raw
    # boundary rows: zero normal flux, as friction_apply
    out[0, :] = z_flux[0, :]
    out[-1, :] = z_flux[-1, :] + 2.0 * ((-r_m * Frm) / (R * dr))[-1, :]
    out[:, 0] = 2.0 * Fz[:, 0] / dz + r_flux[:, 0]
    out[:, -1] = 2.0 * (-Fzm[:, -1]) / dz + r_flux[:, -1]
    return out


def rfp_fd_hint(Drr, Dzz, mesh):
    """Frozen separable surrogate of the implicit-RFP operator
    ``friction_apply(...) - diffusion_apply(...)`` for the
    fast-diagonalization preconditioner (``fdm.custom(..., fd_hint=...)``,
    consumed by ``precond: "fd"``).

    The diagonal diffusion parts keep ``diffusion_apply``'s conservative
    face weights and boundary rows, with the coefficients frozen to their
    cross-axis means (``D̄rr(r) = mean_z Drr``, ``D̄zz(z) = mean_r Dzz``:
    each axis matrix depends on its own coordinate only). The drift and
    the ``D_rz`` cross terms are left out (not diagonally symmetrizable /
    not separable). The r = 0 row is decoupled radially.

    Reads ``Drr`` and ``Dzz`` to the host (two device-to-host copies) and
    returns per-axis ``(ap, ac, am)`` float64 numpy vectors of the
    surrogate of the custom TERM (minus the diffusion surrogate, as
    ``rfp_op = friction - diffusion``)."""
    Drr = torch.as_tensor(Drr).detach().to("cpu", torch.float64).numpy()
    Dzz = torch.as_tensor(Dzz).detach().to("cpu", torch.float64).numpy()
    r = np.asarray(mesh._x_np[0], dtype=np.float64)
    dr = float(mesh.dx_np[0])
    dz = float(mesh.dx_np[1])
    nr, nz = Drr.shape

    # radial axis: (1/r) d_r(r D̄rr d_r f), conservative faces
    Dr = Drr.mean(axis=1)
    ap_r = np.zeros(nr)
    am_r = np.zeros(nr)
    r_p = np.empty(nr)
    r_m = np.empty(nr)
    r_p[:-1] = (r[1:] + r[:-1]) / 2.0
    r_p[-1] = r[-1]  # unused (the boundary row overrides it)
    r_m[1:] = (r[1:] + r[:-1]) / 2.0
    r_m[0] = r[0]
    i = np.arange(1, nr - 1)
    ap_r[i] = r_p[i] * (Dr[i + 1] + Dr[i]) / (2.0 * r[i] * dr * dr)
    am_r[i] = r_m[i] * (Dr[i] + Dr[i - 1]) / (2.0 * r[i] * dr * dr)
    # r = R boundary row of diffusion_apply: 2 * (-r_m * Drr_Pr_rmz)/(R dr)
    am_r[-1] = r_m[-1] * (Dr[-1] + Dr[-2]) / (r[-1] * dr * dr)
    # the r = 0 row drops all radial flux: decouple both ways, so the
    # tridiagonal stays diagonally symmetrizable
    am_r[1] = 0.0
    ac_r = -(ap_r + am_r)

    # axial axis: d_z(D̄zz d_z f)
    Dz = Dzz.mean(axis=0)
    ap_z = np.zeros(nz)
    am_z = np.zeros(nz)
    j = np.arange(1, nz - 1)
    ap_z[j] = (Dz[j + 1] + Dz[j]) / (2.0 * dz * dz)
    am_z[j] = (Dz[j] + Dz[j - 1]) / (2.0 * dz * dz)
    # zero-flux boundary rows (the doubled one-sided face flux)
    ap_z[0] = (Dz[1] + Dz[0]) / (dz * dz)
    am_z[-1] = (Dz[-1] + Dz[-2]) / (dz * dz)
    ac_z = -(ap_z + am_z)

    return (
        (-ap_r, -ac_r, -am_r),
        (-ap_z, -ac_z, -am_z),
    )


def mc_limiter(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Monotonized-central flux limiter (reference ``rfp.py:260-263``)."""
    return minmod(2.0 * minmod(a, b), (a + b) / 2.0)


def minmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Min-mod function (reference ``rfp.py:266-282``)."""
    zero = torch.zeros_like(a)
    same_pos = (a >= 0.0) & (b >= 0.0)
    same_neg = (a < 0.0) & (b < 0.0)
    val = torch.where(same_pos, torch.minimum(a, b), zero)
    val = torch.where(same_neg, torch.maximum(a, b), val)
    return torch.where((a * b) <= 0.0, zero, val)
