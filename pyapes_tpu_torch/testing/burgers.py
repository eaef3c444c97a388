"""Exact solution of the 1-D viscous Burgers equation (port of
``pyapes_tpu/testing/burgers.py``; reference ``pyapes/testing/burgers.py``).

Reference: http://www.thevisualroom.com/burgers_equation.html
"""
from __future__ import annotations

from math import pi

import torch

from pyapes_tpu_torch.mesh import Mesh


def burger_exact_nd(mesh: Mesh, nu: float, t: float) -> torch.Tensor:
    """Travelling-wave exact solution on a 1-D mesh, shape ``(nx,)``."""
    if mesh.dim != 1:
        raise NotImplementedError
    x = mesh.X
    phi = torch.exp(-((x - 4 * t) ** 2) / (4 * nu * (t + 1))) + torch.exp(
        -((x - 4 * t - 2 * pi) ** 2) / (4 * nu * (t + 1))
    )
    dphi_dx = -(
        0.5 * (x - 4 * t) / (nu * (t + 1))
        * torch.exp(-((x - 4 * t) ** 2) / (4 * nu * (t + 1)))
    ) - (
        0.5 * (x - 4 * t - 2 * pi) / (nu * (t + 1))
        * torch.exp(-((x - 4 * t - 2 * pi) ** 2) / (4 * nu * (t + 1)))
    )
    return -2 * nu * dphi_dx / phi + 4
