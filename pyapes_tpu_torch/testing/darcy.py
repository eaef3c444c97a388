"""Heterogeneous-Darcy case setup of the runner's ``darcy`` case (the JAX
package's ``testing/darcy.py``; host numpy only, so both packages build the
same permeability from the same seed)."""
from __future__ import annotations

import numpy as np


def log_normal_permeability(mesh, seed: int = 7, contrast: float = -2.5) -> np.ndarray:
    """Smooth log-normal background (a few random Fourier modes) with two
    low-permeability circular inclusions of log-magnitude ``contrast``."""
    X, Y = (np.asarray(g) for g in mesh._grid_np)
    rng = np.random.default_rng(seed)
    logk = np.zeros_like(X)
    for _ in range(6):
        kx, ky = rng.integers(1, 4, size=2)
        ph = rng.uniform(0, 2 * np.pi, size=2)
        logk += 0.5 * np.cos(2 * np.pi * kx * X + ph[0]) * np.cos(2 * np.pi * ky * Y + ph[1])
    logk += contrast * (
        ((X - 0.35) ** 2 + (Y - 0.6) ** 2 < 0.12**2)
        | ((X - 0.7) ** 2 + (Y - 0.3) ** 2 < 0.10**2)
    )
    return np.exp(logk)


def inlet_outlet_flux(K: np.ndarray, p: np.ndarray, mesh):
    """Darcy volume fluxes through the inlet (x=0) and outlet (x=Lx)
    columns: ``q = -K_face dp/dx`` on the adjacent half-cell faces,
    integrated over the transverse axis."""
    dx, dy = (float(d) for d in mesh.dx_np)
    Kf_in = 0.5 * (K[0] + K[1])
    Kf_out = 0.5 * (K[-1] + K[-2])
    q_in = float(np.sum(-Kf_in * (p[1] - p[0]) / dx) * dy)
    q_out = float(np.sum(-Kf_out * (p[-1] - p[-2]) / dx) * dy)
    return q_in, q_out
