"""Implicit-operator DSL ``FDM`` (OpenFOAM ``fvm``-like), PyTorch port of
``pyapes_tpu/solver/fdm.py``.

The DSL surface is the JAX package's — ``solver.set_eq(fdm.laplacian(1.0,
var) == rhs)`` builds an equation record — and each operator stores the
per-axis structured stencil (host numpy vectors; ``ops/stencil.py``) or,
for a per-point coefficient, the operand the kernels stream.

Ported: ``Operators``, the ``Laplacian`` with a scalar coefficient or a
spatially varying one (the conservative variable-Γ operator, isotropic or
diagonal-tensor Γ), ``Div`` (constant advection: 3- or 5-point axis
vectors; an advecting field: the per-point ``div_field`` term), ``Conv``
(the vector convection ``conv_field`` term), ``Grad`` (central differences,
a per-axis stencil term), ``Ddt`` (backward Euler, BDF2) and ``Custom`` (a
linear torch function, with an optional separable ``fd_hint`` for the FD
preconditioner).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from pyapes_tpu_torch.ops.advect import advect_pair, conv_component
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil
from pyapes_tpu_torch.ops.diff_field import diff_field
from pyapes_tpu_torch.ops.stencil import (
    div_axis_coeffs,
    div_surgery_info,
    grad_axis_coeffs,
    laplacian_axis_coeffs,
)
from pyapes_tpu_torch.parallel import blocks
from pyapes_tpu_torch.parallel.blocks import BlockTensor
from pyapes_tpu_torch.solver.fdc import FDC, conv_rhs_adjust
from pyapes_tpu_torch.solver.types import DiscretizerConfigType, OPStype
from pyapes_tpu_torch.utils.carry import coeffs_from_numpy
from pyapes_tpu_torch.variables import Field


@dataclass(eq=False)
class Operators:
    """Base of FDM operators (reference ``fdm.py:27-105``).

    * ``==`` assigns the RHS (deliberately shadows equality — kept for API
      parity; ``__hash__`` uses identity so records stay usable in dicts).
    * ``+`` / ``-`` append a term; ``-`` flips its sign.
    """

    _ops: dict[int, OPStype] = field(default_factory=dict)
    _rhs: torch.Tensor | None = None
    _config: DiscretizerConfigType | None = None

    @property
    def ops(self) -> dict[int, OPStype]:
        return self._ops

    @ops.setter
    def ops(self, other: dict) -> None:
        self._ops = other

    @property
    def rhs(self) -> torch.Tensor | None:
        return self._rhs

    @rhs.setter
    def rhs(self, other) -> None:
        self._rhs = other

    @property
    def var(self) -> Field:
        raise NotImplementedError

    def update_config(self, config: DiscretizerConfigType) -> None:
        self._config = config

    @property
    def config(self) -> DiscretizerConfigType | None:
        return self._config

    def __hash__(self) -> int:
        return id(self)

    def __eq__(self, other) -> "Operators":
        x = self.var()
        if isinstance(other, Field):
            self._rhs = other()
        elif isinstance(other, (int, float)):
            self._rhs = torch.zeros_like(x) + other
        elif isinstance(x, BlockTensor):
            # a target on blocks: the RHS on its blocks, each block's slice
            # copied straight to its device (a block RHS stays as it is)
            rhs = other if isinstance(other, torch.Tensor) else torch.as_tensor(other)
            self._rhs = blocks.scatter(rhs.to(x.dtype), x.placement)
        else:
            self._rhs = torch.as_tensor(other, dtype=x.dtype, device=x.device)
        assert self._rhs.shape == x.shape, (
            f"FDM Operators: RHS shape {tuple(self._rhs.shape)} does not match {tuple(x.shape)}!"
        )
        return self

    def __add__(self, other: "Operators") -> "Operators":
        idx = list(self._ops.keys())
        self._ops.update({idx[-1] + 1: other.ops[0]})
        return self

    def __sub__(self, other: "Operators") -> "Operators":
        idx = list(self._ops.keys())
        other.ops[0]["sign"] = -1
        self._ops.update({idx[-1] + 1: other.ops[0]})
        return self

    def __neg__(self) -> "Operators":
        self._ops[0]["sign"] = -1
        return self


class Laplacian(Operators):
    r"""Implicit Laplacian :math:`\partial_j (\Gamma \partial_j \Phi)`
    (reference ``fdm.py:108-169``)."""

    def __call__(self, *inputs: Any, avg: str = "arithmetic") -> "Laplacian":
        if len(inputs) == 2:
            coeff = inputs[0]
            if isinstance(coeff, int):
                coeff = float(coeff)
            var = inputs[1]
            if isinstance(coeff, (tuple, list)):
                # per-axis (diagonal-tensor) diffusivity: stacked (dim, *nx),
                # axis j diffusing with coeff[j]; scalars broadcast
                coeff = torch.stack([
                    torch.as_tensor(c, device=var.mesh.device).to(torch.float64)
                    .broadcast_to(tuple(var.mesh.nx))
                    for c in coeff
                ])
        elif len(inputs) == 1:
            coeff = None
            var = inputs[0]
        else:
            raise TypeError("FDM: invalid input type!")
        assert isinstance(var, Field), "FDM Laplacian: var must be a Field!"
        if coeff is not None and np.ndim(coeff) >= var.mesh.dim:
            # spatially varying: the CONSERVATIVE ∂_j (Γ(x) ∂_j φ), a
            # per-point operand (the scalar path would be Γ ∇²φ)
            return self._call_var_gamma(coeff, var, avg)

        self._var = var
        self._ops = {
            0: {
                "name": self.__class__.__name__,
                "Aop": self.Aop,
                "target": var,
                "param": (coeff,),
                "sign": 1.0,
                "other": None,
                "axis_coeffs": laplacian_axis_coeffs(var.mesh, var.bcs),
                "A_coeffs": None,
                "adv": None,
                "limiter": None,
                "dt": None,
                "adjust_rhs": lambda v=var: FDC({"laplacian": {"edge": False}}).laplacian.adjust_rhs(v),
            }
        }
        return self

    def _call_var_gamma(self, coeff, var: Field, avg: str = "arithmetic") -> "Laplacian":
        """Variable-coefficient (heterogeneous-diffusivity) Laplacian, on
        Cartesian meshes with Dirichlet and zero-flux Neumann/Symmetry
        faces. The Neumann boundary-node elimination carries the local face
        Γ, which makes the surgered rows nonsymmetric: solve Neumann cases
        with BiCGSTAB (all-Dirichlet systems are SPD).

        ``coeff``: a tensor or numpy array of shape ``nx`` (isotropic) or
        ``(dim, *nx)`` (diagonal-tensor Γ); ``avg`` ("arithmetic" |
        "harmonic") picks the face-value rule."""
        assert avg in ("arithmetic", "harmonic"), avg
        mesh = var.mesh
        if mesh.coord_sys != "xyz":
            raise NotImplementedError("fdm.laplacian(gamma_array, var): rz meshes not supported")
        for bc in var.bcs or []:
            if bc.bc_type == "neumann" and bc.bc_val not in (None, 0, 0.0):
                raise NotImplementedError(
                    "fdm.laplacian(gamma_array, var): nonzero Neumann flux values are not "
                    "wired into the RHS yet"
                )
            if bc.bc_type in ("obstacle_dirichlet", "obstacle_neumann"):
                raise NotImplementedError(
                    "fdm.laplacian(gamma_array, var): obstacle BCs are not supported yet"
                )
        gamma = torch.as_tensor(coeff)
        if gamma.ndim == mesh.dim + 1 and gamma.shape[0] == 1:
            gamma = gamma[0]
        want = (mesh.dim, *mesh.nx) if gamma.ndim == mesh.dim + 1 else tuple(mesh.nx)
        if tuple(gamma.shape) != want:
            raise ValueError(f"fdm.laplacian: gamma shape {tuple(gamma.shape)} != {want}")
        self._var = var
        self._ops = {
            0: {
                "name": self.__class__.__name__,
                "Aop": self.Aop_var_gamma,
                "target": var,
                "param": (gamma,),
                "sign": 1.0,
                "other": {
                    "var_gamma": True,
                    "surgery": div_surgery_info(var.bcs, mesh.dim),
                    "inv_dx2": tuple(1.0 / float(d) ** 2 for d in mesh.dx_np),
                    "avg": avg,
                },
                "axis_coeffs": None,
                "A_coeffs": None,
                "adv": None,
                "limiter": None,
                "dt": None,
                "adjust_rhs": None,
            }
        }
        return self

    @staticmethod
    def Aop_var_gamma(rec: OPStype, x: torch.Tensor) -> torch.Tensor:
        g = blocks.lead_copy(rec["param"][0]).to(device=x.device, dtype=x.dtype).contiguous()
        o = rec["other"]
        return diff_field(x, g, o["inv_dx2"], o["surgery"], o["avg"])

    @property
    def var(self) -> Field:
        return self._var

    @staticmethod
    def Aop(rec: OPStype, x: torch.Tensor) -> torch.Tensor:
        out = axis_stencil(coeffs_from_numpy(rec["axis_coeffs"], x.device, x.dtype), x)
        coeff = rec["param"][0]
        return out if coeff is None else out * coeff


class Grad(Operators):
    r"""Implicit gradient :math:`\nabla \Phi` (reference ``fdm.py:270-319``).
    In an equation its ``(var.dim, mesh.dim, *nx)`` output is summed over
    the mesh axes (the JAX package's rule; the original reshape holds in
    1-D only, where the two coincide): the per-axis vectors
    ``(1, 0, -1) / (2 dx)`` with the boundary-node elimination, times an
    optional scalar coefficient."""

    def __call__(self, *inputs: Any) -> "Grad":
        if len(inputs) == 2:
            coeff, var = inputs
        elif len(inputs) == 1:
            coeff, var = None, inputs[0]
        else:
            raise TypeError("FDM: invalid input type!")
        assert isinstance(var, Field), "FDM Grad: var must be a Field!"
        self._var = var
        self._ops = {
            0: {
                "name": self.__class__.__name__,
                "Aop": self.Aop,
                "target": var,
                "param": (coeff,),
                "sign": 1.0,
                "other": None,
                "axis_coeffs": grad_axis_coeffs(var.mesh, var.bcs),
                "A_coeffs": None,
                "adv": None,
                "limiter": None,
                "dt": None,
                "adjust_rhs": lambda v=var: FDC({"grad": {"edge": False}}).grad.adjust_rhs(v),
            }
        }
        return self

    @property
    def var(self) -> Field:
        return self._var

    Aop = staticmethod(Laplacian.Aop)


def _adv_tensor(u, var: Field) -> torch.Tensor:
    """An advecting argument (Field, tensor or array) as a tensor in the
    target's dtype and device, frozen at equation-build time."""
    x = var()
    a = u() if isinstance(u, Field) else u
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


class Div(Operators):
    r"""Implicit divergence :math:`\partial_j (u_j \phi_i)` (reference
    ``fdm.py:321-402``).

    * Constant advection (float): the coefficients fold into the per-axis
      stencil (central, upwind, or QUICK's 5-vectors).
    * Field/array advection: the advecting values are FROZEN at
      equation-build time and multiplied in at apply time (Picard
      linearization; outer sweeps via the solver's ``picard`` config) —
      the per-point ``div_field`` term.
    """

    def __call__(self, *inputs: Any) -> "Div":
        if len(inputs) == 2:
            var_j, var_i = inputs
        elif len(inputs) == 1:
            var_j, var_i = 1.0, inputs[0]
        else:
            raise TypeError("FDM: invalid input type!")
        assert isinstance(var_i, Field), "FDM Div: var_i must be a Field!"
        if isinstance(var_j, int):
            var_j = float(var_j)
        config = self.config or {"div": {"limiter": "none", "edge": False}}
        limiter = config.get("div", {}).get("limiter", "none")
        form = config.get("div", {}).get("form", "conservative")
        self._var_i = var_i
        mesh = var_i.mesh
        if isinstance(var_j, float):
            axis_coeffs = div_axis_coeffs(mesh, var_i.bcs, var_j, limiter)
            adv = base = surgery = None
        else:
            adv = _adv_tensor(var_j, var_i)
            axis_coeffs = None
            base = div_axis_coeffs(mesh, None, 1.0, "none")
            surgery = div_surgery_info(var_i.bcs, mesh.dim)
        self._ops = {
            0: {
                "name": self.__class__.__name__,
                "Aop": self.Aop,
                "target": var_i,
                "param": (var_j, config),
                "sign": 1.0,
                "other": {"base": base, "surgery": surgery, "form": form},
                "axis_coeffs": axis_coeffs,
                "A_coeffs": None,
                "adv": adv,
                "limiter": limiter,
                "dt": None,
                "adjust_rhs": lambda vj=var_j, vi=var_i, cfg=config: FDC(cfg).div.adjust_rhs(
                    vj, vi, cfg),
            }
        }
        return self

    @property
    def var(self) -> Field:
        return self._var_i

    @staticmethod
    def Aop(rec: OPStype, x: torch.Tensor) -> torch.Tensor:
        if rec["adv"] is None:
            return axis_stencil(coeffs_from_numpy(rec["axis_coeffs"], x.device, x.dtype), x)
        o = rec["other"]
        return advect_pair(x, blocks.lead_copy(rec["adv"]).to(x.dtype).contiguous(),
                           coeffs_from_numpy(o["base"], x.device, x.dtype), rec["limiter"],
                           o["surgery"], o["form"])


class Conv(Operators):
    r"""Implicit convection :math:`u_j \partial \phi_i / \partial x_j` for
    vector targets (reference ``fdm.py:405-468``): advective form, one
    advecting component per MESH AXIS, frozen at equation-build time (the
    ``conv_field`` term)."""

    def __call__(self, u, var: Field) -> "Conv":
        assert isinstance(var, Field), "FDM Conv: var must be a Field!"
        adv = _adv_tensor(u, var)
        assert adv.shape[0] == var.mesh.dim, (
            "FDM Conv: advecting field needs one component per mesh axis"
        )
        config = self.config or {"div": {"limiter": "none", "edge": False}}
        limiter = config.get("div", {}).get("limiter", "none")
        mesh = var.mesh
        self._var = var
        self._ops = {
            0: {
                "name": self.__class__.__name__,
                "Aop": self.Aop,
                "target": var,
                "param": (u, config),
                "sign": 1.0,
                "other": {"base": div_axis_coeffs(mesh, None, 1.0, "none"),
                          "surgery": div_surgery_info(var.bcs, mesh.dim), "form": "advective"},
                "axis_coeffs": None,
                "A_coeffs": None,
                "adv": adv,
                "limiter": limiter,
                "dt": None,
                "adjust_rhs": lambda a=adv, v=var, lim=limiter: conv_rhs_adjust(a, v, lim),
            }
        }
        return self

    @property
    def var(self) -> Field:
        return self._var

    @staticmethod
    def Aop(rec: OPStype, x: torch.Tensor) -> torch.Tensor:
        o = rec["other"]
        return conv_component(x, blocks.lead_copy(rec["adv"]).to(x.dtype).contiguous(),
                              coeffs_from_numpy(o["base"], x.device, x.dtype), rec["limiter"],
                              o["surgery"])


class Custom(Operators):
    """An arbitrary matrix-free linear operator in the equation DSL (JAX
    ``fdm.py:471-527``).

    ``fdm.custom(fn, var, params)`` adds the term ``fn(x, *params)``: a
    torch function of the solution tensor, shape-preserving and LINEAR in
    ``x`` (e.g. the Rosenbluth–Fokker–Planck collision operator with
    frozen potentials, ``models/rfp_evolution.py``). ``params`` are
    tensors passed through to every call as they are (never copied).

    ``fd_hint`` (optional): a frozen SEPARABLE surrogate of ``fn`` for the
    fast-diagonalization preconditioner (``precond: "fd"``): per mesh
    axis, three full-length vectors ``(ap, ac, am)`` (+1/0/-1 neighbour
    offsets) whose summed tridiagonals approximate ``fn``. It changes only
    the preconditioner. It is normalised to a nested float tuple, so the
    solver and eigen-factor caches key on its content: a refreshed hint
    re-factorises, an equal one reuses the factors.
    """

    def __call__(self, fn, var: Field, params=(), fd_hint=None) -> "Custom":
        assert isinstance(var, Field), "FDM Custom: var must be a Field!"
        self._var = var
        if fd_hint is not None:
            fd_hint = tuple(
                tuple(tuple(float(x) for x in vec) for vec in ax) for ax in fd_hint
            )
        self._ops = {
            0: {
                "name": self.__class__.__name__,
                "Aop": self.Aop,
                "target": var,
                "param": (fn,),
                "sign": 1.0,
                "other": {"fn": fn, "fd_hint": fd_hint},
                "axis_coeffs": None,
                "A_coeffs": None,
                "adv": None,
                "limiter": None,
                "dt": None,
                "custom_params": tuple(params),
                "adjust_rhs": None,
            }
        }
        return self

    @property
    def var(self) -> Field:
        return self._var

    @staticmethod
    def Aop(rec: OPStype, x: torch.Tensor) -> torch.Tensor:
        return rec["other"]["fn"](x, *rec.get("custom_params", ()))


class Ddt(Operators):
    r"""Implicit time derivative (reference ``fdm.py:530-575``): backward
    Euler contributes ``x / dt`` to the operator and ``var_old / dt`` to the
    RHS; BDF2 (``scheme="bdf2"``) ``1.5 x / dt`` and ``(2 var_old - 0.5
    var_oold) / dt``, bootstrapping as backward Euler until two history
    levels exist."""

    def __call__(self, var: Field, scheme: str = "euler") -> "Ddt":
        dt = var.dt  # raises if not set
        assert scheme in ("euler", "bdf2")
        self._var = var
        self._ops = {
            0: {
                "name": self.__class__.__name__,
                "Aop": self.Aop,
                "target": var,
                "param": (dt,),
                "sign": 1.0,
                "other": {"scheme": scheme},
                "axis_coeffs": None,
                "A_coeffs": None,
                "adv": None,
                "limiter": None,
                "dt": dt,
                "adjust_rhs": None,
            }
        }
        return self

    @property
    def var(self) -> Field:
        return self._var

    @staticmethod
    def Aop(rec: OPStype, x: torch.Tensor) -> torch.Tensor:
        """Linear part only: ``c0 x / dt`` (c0 = 1.5 for active BDF2)."""
        return ddt_leading_coeff(rec) * x / rec["dt"]


def ddt_leading_coeff(rec) -> float:
    """1.5 when BDF2 is requested AND two history levels exist, else 1.0
    (reference ``fdm.py:577-584``)."""
    if (rec["other"] or {}).get("scheme") != "bdf2":
        return 1.0
    return 1.5 if rec["target"].n_hist >= 2 else 1.0


class FDM:
    """Facade over the implicit operators (reference ``fdm.py:356-407``);
    operators are per instance."""

    def __init__(self, config: DiscretizerConfigType | None = None) -> None:
        self.laplacian = Laplacian()
        self.grad = Grad()
        self.div = Div()
        self.conv = Conv()
        self.custom = Custom()
        self.ddt = Ddt()
        self.config = config
        if config is not None:
            self.div.update_config(config)
            self.conv.update_config(config)
