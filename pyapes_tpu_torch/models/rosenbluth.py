"""Self-consistent Rosenbluth potentials in rz velocity space (PyTorch
port of ``pyapes_tpu/models/rosenbluth.py``).

Like-species Trubnikov/Rosenbluth potentials:

    H(v) = 2 \\int f(v') / |v - v'| d^3v'    =>  lap H = -8 pi f
    G(v) =     \\int f(v') |v - v'| d^3v'    =>  lap G = H

Both are Poisson problems on the axisymmetric mesh: the 1/r metric terms
ride in the rz Laplacian's radial vectors and the r = 0 axis takes a
symmetry condition. The outer faces carry the monopole (far-field)
Dirichlet values ``H_b = 2 N / |v_b - v_mean|``, ``G_b = N |v_b -
v_mean|``; N and the mean parallel velocity are collisional invariants,
so they are taken once from the initial distribution (numpy, on the
host) and the two solvers are reused with a new right-hand side at every
refresh.
"""
from __future__ import annotations

from math import pi

import numpy as np
import torch

from pyapes_tpu_torch.mesh import Mesh
from pyapes_tpu_torch.solver.fdm import FDM
from pyapes_tpu_torch.solver.ops import Solver
from pyapes_tpu_torch.variables import Field
from pyapes_tpu_torch.variables.bcs import CylinderBoundary


def _host(a) -> np.ndarray:
    """A tensor or array as host numpy, in its own dtype."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class RosenbluthPotentials:
    """Solve H and G for a distribution on an rz velocity mesh.

    Args:
        mesh: Cylinder mesh (r = perpendicular speed, z = parallel).
        f0: initial distribution values ``(*nx)`` (tensor or numpy): fixes
            the conserved moments (N, z-mean) of the far-field values.
        config: optional solver-config overrides (tol, precond, ...).

    The default config is the JAX package's: ``method: "fastdiag"`` with
    ``fd_fallback: "bicgstab"`` and ``precond: "mg"``. The port resolves it
    to the fastdiag direct solve (the rz Laplacian is separable and its
    radial axis diagonally symmetrizable); the JAX package takes its
    BiCGSTAB + rz-MG fallback there (its ``bc_mask`` probe rejects every
    domain BC, a fault the port does not copy).
    """

    def __init__(self, mesh: Mesh, f0, config: dict | None = None):
        assert mesh.coord_sys == "rz"
        self.mesh = mesh

        # conserved moments of f0 (host, once)
        f0 = _host(f0)
        R, Z = np.asarray(mesh._grid_np[0]), np.asarray(mesh._grid_np[1])
        dr, dz = (float(d) for d in mesh.dx_np)
        w = 2.0 * pi * R * dr * dz
        self.N = float((f0 * w).sum())
        self.z_mean = float((f0 * Z * w).sum() / max(self.N, 1e-300))

        N, z_mean = self.N, self.z_mean

        def dist(grid):
            r, z = grid
            return torch.sqrt(r**2 + (z - z_mean) ** 2 + 1e-30)

        # callable Dirichlet values (full-grid tensors; the BC takes the
        # face row)
        self._h_bc_val = lambda grid, mask, var, opt: 2.0 * N / dist(grid)
        self._g_bc_val = lambda grid, mask, var, opt: N * dist(grid)

        # the r-low face is the symmetry axis; the other three: monopole
        def bcs(val):
            return CylinderBoundary(
                rl={"bc_type": "symmetry", "bc_val": None},
                ru={"bc_type": "dirichlet", "bc_val": val},
                zl={"bc_type": "dirichlet", "bc_val": val},
                zu={"bc_type": "dirichlet", "bc_val": val},
            )()

        cfg = {
            "method": "fastdiag",
            "fd_fallback": "bicgstab",
            "tol": 1e-8,
            "max_it": 2000,
            "report": False,
            "criterion": "residual",
            "precond": "mg",
        }
        cfg.update(config or {})
        self._h = Field("H", 1, mesh, {"domain": bcs(self._h_bc_val)})
        self._g = Field("G", 1, mesh, {"domain": bcs(self._g_bc_val)})
        self._solver_h = Solver({"fdm": dict(cfg)})
        self._solver_g = Solver({"fdm": dict(cfg)})
        self._fdm = FDM()

    @property
    def reports(self) -> tuple:
        """The last ``(H, G)`` solve reports."""
        return self._solver_h.report, self._solver_g.report

    def solve(self, f) -> tuple[torch.Tensor, torch.Tensor]:
        """``(H, G)`` grid tensors for the distribution values ``f``
        (``(*nx)`` or ``(1, *nx)``), on the mesh's device; the two solvers
        are reused."""
        x = self._h()
        fv = torch.as_tensor(f, dtype=x.dtype, device=x.device)
        if fv.ndim == self.mesh.dim:
            fv = fv[None]

        self._h.set_var_tensor(torch.zeros_like(fv))
        self._solver_h.set_eq(self._fdm.laplacian(1.0, self._h) == -8.0 * pi * fv)
        self._solver_h.solve()
        H = self._h()[0]

        self._g.set_var_tensor(torch.zeros_like(fv))
        self._solver_g.set_eq(self._fdm.laplacian(1.0, self._g) == H[None])
        self._solver_g.solve()
        return H, self._g()[0]


def maxwellian_H(mesh: Mesh, N: float, vth: float) -> np.ndarray:
    """Analytic H of a centred Maxwellian (a validation oracle, host
    numpy): ``H(v) = 2 N erf(v / (sqrt(2) vth)) / v``."""
    from scipy.special import erf

    R, Z = np.asarray(mesh._grid_np[0]), np.asarray(mesh._grid_np[1])
    v = np.sqrt(R**2 + Z**2)
    xi = v / (np.sqrt(2.0) * vth)
    return np.where(
        v > 1e-12,
        2.0 * N * np.where(v > 1e-12, erf(xi), 0.0) / np.maximum(v, 1e-12),
        2.0 * N * np.sqrt(2.0 / pi) / vth,
    )
