"""Finite-difference explicit discretizers ``FDC`` (PyTorch port of the part
of ``pyapes_tpu/solver/fdc.py`` that ``fdm.laplacian`` reaches).

Ported: the ``Discretizer`` base, ``AxisCoeffs``, the ``Laplacian``'s
``build_A_coeffs`` and ``adjust_rhs`` (the Neumann flux correction the
implicit Laplacian folds into the RHS), and the Neumann RHS corrections of
the implicit advection terms (``Div.adjust_rhs``, ``conv_rhs_adjust``).
The explicit apply (``fdc.laplacian(var)``, ``fdc.div(...)``), the Div's
per-point banks, Grad and DiffFlux are ported in later slices and raise
``NotImplementedError``.
"""
from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from dataclasses import dataclass

import torch

from pyapes_tpu_torch.solver.types import DiscretizerConfigType
from pyapes_tpu_torch.variables import Field
from pyapes_tpu_torch.variables.bcs import BC


def _row_sel(axis: int, idx, leading: int = 0) -> tuple:
    return (slice(None),) * (leading + axis) + (idx,)


def _face_bcs(var: Field, axis: int):
    """Domain-face BCs whose normal has a component along ``axis``."""
    for bc in var.bcs or []:
        n_vec = getattr(bc, "bc_n_vec", None)
        if n_vec is None or n_vec[axis] == 0:
            continue
        yield bc


@dataclass
class Discretizer(ABC):
    """Base explicit discretizer (reference ``fdc.py:25-168``)."""

    A_coeffs: list | None = None
    rhs_adj: torch.Tensor | None = None
    _op_type: str = "Discretizer"
    _config: DiscretizerConfigType | None = None

    @property
    def op_type(self) -> str:
        return self._op_type

    @property
    def config(self) -> DiscretizerConfigType | None:
        return self._config

    @staticmethod
    @abstractmethod
    def build_A_coeffs(*args, config=None):
        ...

    @staticmethod
    @abstractmethod
    def adjust_rhs(*args, config=None) -> torch.Tensor:
        ...

    def reset(self) -> None:
        self.A_coeffs = None
        self.rhs_adj = None

    def set_config(self, config: DiscretizerConfigType) -> None:
        self._config = config

    def __call__(self, *args, **kwargs):
        raise NotImplementedError(
            f"FDC: the explicit {self.op_type} apply is ported in a later slice"
        )


class AxisCoeffs:
    """Separable explicit-stencil representation: per-axis 1-D coefficient
    vectors instead of five full-grid banks (``tools.py:29-112``)."""

    def __init__(self, vecs):
        self.vecs = tuple(tuple(v) for v in vecs)


class Laplacian(Discretizer):
    """Laplacian discretizer (reference ``fdc.py:369-458``)."""

    def __init__(self):
        self._op_type = __class__.__name__
        self._config = None
        self.A_coeffs = None
        self.rhs_adj = None

    @staticmethod
    def build_A_coeffs(var: Field, config=None) -> AxisCoeffs:
        """Separable per-axis coefficient vectors (boundary-node
        elimination for Neumann/Symmetry faces)."""
        from pyapes_tpu_torch.ops.stencil import laplacian_axis_coeffs

        return AxisCoeffs(laplacian_axis_coeffs(var.mesh, var.bcs, dtype=var().dtype))

    @staticmethod
    def adjust_rhs(var: Field, config=None) -> torch.Tensor:
        """Neumann flux correction folded into the RHS.

        The eliminated coefficient ``c0`` (the bank value pointing at the
        boundary node, pre ``1/dx^2`` scaling) carries the constant part of
        the BC application ``v_b = (4 v1 - v2)/3 + (2/3) V dx``, so
        ``rhs += -(2/3) c0 V / dx`` on the adjacent row, for both faces
        (the JAX package's rule; see its PARITY.md)."""
        mesh = var.mesh
        rhs_adj = torch.zeros_like(var())
        dx = mesh.dx_np
        for i in range(var.dim):
            for j in range(mesh.dim):
                for bc in _face_bcs(var, j):
                    if bc.bc_type != "neumann":
                        continue
                    pi = 1 if bc.bc_n_dir < 0 else -2
                    bi = 0 if bc.bc_n_dir < 0 else -1
                    c0 = 1.0  # Cartesian: the eliminated Am (lower) / Ap (upper)
                    at_bc = _return_bc_val(bc, var, i, j, bi)
                    rhs_adj[(i,) + _row_sel(j, pi)] += torch.as_tensor(
                        -(2.0 / 3.0) * c0 * at_bc / dx[j], dtype=rhs_adj.dtype, device=rhs_adj.device
                    )
        return rhs_adj


class Div(Discretizer):
    """Divergence discretizer (reference ``fdc.py:605-683``): the
    constant-advection coefficient vectors and the Neumann RHS correction
    of the implicit ``fdm.div``."""

    def __init__(self):
        self._op_type = __class__.__name__
        self._config = None
        self.A_coeffs = None
        self.rhs_adj = None

    @staticmethod
    def build_A_coeffs(var_j, var_i: Field, config) -> AxisCoeffs:
        """Separable per-axis vectors of a spatially constant advection
        (the vectors the implicit path uses)."""
        from pyapes_tpu_torch.ops.stencil import div_axis_coeffs

        if not isinstance(var_j, (int, float)) or isinstance(var_j, bool):
            raise NotImplementedError("FDC Div: per-point banks are ported in a later slice")
        return AxisCoeffs(div_axis_coeffs(var_i.mesh, var_i.bcs, float(var_j),
                                          _check_limiter(config["div"]), dtype=var_i().dtype))

    @staticmethod
    def adjust_rhs(var_j, var_i: Field, config) -> torch.Tensor:
        """Neumann RHS correction of the implicit Div (reference
        ``fdc.py:660-683``): central takes the advection at the boundary
        node (conservative) or at the row (advective); upwind and QUICK
        (upwind next to the faces) the split ``min``/``max`` parts."""
        rhs_adj = torch.zeros_like(var_i())
        if var_i.bcs:
            adv = _div_var_j_to_tensor(var_j, var_i)
            limiter = _check_limiter(config["div"])
            if limiter == "none":
                form = config["div"].get("form", "conservative")
                for i in range(var_i.dim):
                    rhs_adj = _grad_rhs_adjust(var_i, rhs_adj, i, (adv,), form)
            elif limiter in ("upwind", "quick"):
                gammas = _gamma_from_adv(adv, var_i)
                for i in range(var_i.dim):
                    rhs_adj = _grad_rhs_adjust(var_i, rhs_adj, i, gammas)
            else:
                raise RuntimeError(f"FDC Div: {limiter=} unknown limiter type.")
        return rhs_adj


def _check_limiter(config) -> str:
    if config is not None and "limiter" in config:
        return config["limiter"].lower()
    warnings.warn("FDM: no limiter is specified. Use `none` (central difference) as default.")
    return "none"


def _grad_rhs_adjust(var: Field, rhs_adj: torch.Tensor, dim: int, gamma=None,
                     form: str = "conservative") -> torch.Tensor:
    """Neumann RHS adjustment shared by Grad/Div (reference
    ``fdc.py:475-518``): ``-c0 V / 3`` on the boundary-adjacent row, ``c0``
    the pre-``1/(2 dx)`` coefficient the surgery eliminates and ``V`` the
    outward-normal flux. ``gamma`` None (Grad: ``c0 = n``), ``(adv,)``
    (central Div: ``c0 = n adv`` at the boundary node, conservative, or at
    the row, advective) or ``(adv_min, adv_max)`` (upwind/QUICK: ``-2
    max`` lower, ``+2 min`` upper, at the row). Adds into ``rhs_adj`` in
    place and returns it."""
    if gamma is not None and len(gamma) == 2:
        gamma_min = 2.0 * gamma[0]
        gamma_max = 2.0 * gamma[1]
    for j in range(var.mesh.dim):
        for bc in _face_bcs(var, j):
            if bc.bc_type != "neumann":
                continue
            pi = 1 if bc.bc_n_dir < 0 else -2
            bi = 0 if bc.bc_n_dir < 0 else -1
            at_bc = _return_bc_val(bc, var, dim, j, bi)
            if gamma is None:
                term = -(1.0 / 3.0) * at_bc * bc.bc_n_dir
            elif len(gamma) == 1:
                g_i = bi if form == "conservative" else pi
                term = -(1.0 / 3.0) * at_bc * bc.bc_n_dir * gamma[0][(dim,) + _row_sel(j, g_i)]
            else:
                g = gamma_max if bc.bc_n_dir < 0 else gamma_min
                term = -(1.0 / 3.0) * at_bc * bc.bc_n_dir * g[(dim,) + _row_sel(j, pi)]
            rhs_adj[(dim,) + _row_sel(j, pi)] += term
    return rhs_adj


def conv_rhs_adjust(adv: torch.Tensor, var: Field, limiter: str = "none") -> torch.Tensor:
    """Neumann RHS adjustment of the Conv operator (reference
    ``fdc.py:521-554``): the eliminated coefficient is ``c0 = n adv[j]`` at
    the adjacent row (central) or ``-2 max`` / ``+2 min`` (upwind, QUICK);
    each adds ``-c0 V_i / 3``. Zero unless the target has nonzero-value
    Neumann faces."""
    rhs_adj = torch.zeros_like(var())
    adv = torch.as_tensor(adv, dtype=rhs_adj.dtype, device=rhs_adj.device)
    for i in range(var.dim):
        for j in range(var.mesh.dim):
            for bc in _face_bcs(var, j):
                if bc.bc_type != "neumann":
                    continue
                pi = 1 if bc.bc_n_dir < 0 else -2
                bi = 0 if bc.bc_n_dir < 0 else -1
                at_bc = _return_bc_val(bc, var, i, j, bi)
                a_row = adv[(j,) + _row_sel(j, pi)]
                if limiter == "none":
                    term = -(1.0 / 3.0) * at_bc * bc.bc_n_dir * a_row
                else:
                    g = (torch.clamp(a_row, min=0.0) if bc.bc_n_dir < 0
                         else torch.clamp(a_row, max=0.0))
                    term = -(2.0 / 3.0) * at_bc * bc.bc_n_dir * g
                rhs_adj[(i,) + _row_sel(j, pi)] += term
    return rhs_adj


def _div_var_j_to_tensor(var_j, var_i: Field) -> torch.Tensor:
    """The advecting argument as a tensor of ``var_i``'s shape, dtype and
    device (reference ``fdc.py:847-861``)."""
    x = var_i()
    if isinstance(var_j, (int, float)) and not isinstance(var_j, bool):
        return torch.ones_like(x) * float(var_j)
    if isinstance(var_j, Field):
        return var_j()
    adv = torch.as_tensor(var_j, dtype=x.dtype, device=x.device)
    assert adv.shape == x.shape, "FDC Div: adv shape must match var_i shape"
    return adv


def _gamma_from_adv(adv: torch.Tensor, var: Field):
    zeros = torch.zeros_like(var())
    return torch.minimum(adv, zeros), torch.maximum(adv, zeros)


def _return_bc_val(bc: BC, var: Field, dim: int, axis: int, face_idx: int):
    """Boundary value resolved to the face row (reference ``fdc.py:803-817``).

    Callables are evaluated on the full grid and sliced to the face row."""
    v = bc.bc_val
    if callable(v):
        full = torch.as_tensor(v(var.mesh.grid, bc.bc_mask, var(), bc.bc_n_vec))
        if full.ndim == var.mesh.dim:
            return full[_row_sel(axis, face_idx)]
        return full
    if isinstance(v, list):
        return v[dim]
    if isinstance(v, (int, float)):
        return float(v)
    if v is None:
        return 0.0
    return torch.as_tensor(v)


class _Unported:
    """Placeholder for an FDC operator of a later slice."""

    def __init__(self, name: str):
        self._name = name

    def set_config(self, config) -> None:
        pass

    def __call__(self, *args, **kwargs):
        raise NotImplementedError(f"FDC: {self._name} is ported in a later slice")


class FDC:
    """Facade over the explicit discretizers (reference ``fdc.py:860-893``);
    per-instance operator objects."""

    def __init__(self, config: DiscretizerConfigType | None = None):
        self.laplacian = Laplacian()
        self.grad = _Unported("grad")
        self.div = Div()
        self.diffFlux = _Unported("diffFlux")
        self.config = config
        if self.config is not None:
            for c in self.config:
                getattr(self, c).set_config(self.config)

    def update_config(self, scheme: str, target: str, val) -> None:
        if self.config is not None:
            self.config.setdefault(scheme, {})[target] = val
        else:
            self.config = {scheme: {target: val}}
        for c in self.config:
            getattr(self, c).set_config(self.config)
