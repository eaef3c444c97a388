"""Finite-difference explicit discretizers ``FDC`` (OpenFOAM ``fvc``-like),
PyTorch port of ``pyapes_tpu/solver/fdc.py``.

Stencils are the per-axis coefficient vectors of ``ops/stencil.py``
(``AxisCoeffs``: the Laplacian, the Grad and a Div with a constant
advection) or, for a Div with a per-point advector, the five full-grid
banks ``[App, Ap, Ac, Am, Amm]`` for offsets ``i+2 .. i-2``. The apply is
the roll-sum ``sum_k coeff_k * roll(var, offset_k, axis)`` on the reduced
torus of a periodic axis, in plain PyTorch: the JAX package computes these
operators with ``jnp.roll`` sums outside any Pallas kernel, so the port
has no kernel for them. ``edge=True`` replaces the boundary rows with
second-order one-sided formulas.

Also here: the Neumann RHS corrections the implicit operators fold into
the RHS (``Laplacian.adjust_rhs``, ``Grad.adjust_rhs``,
``Div.adjust_rhs``, ``conv_rhs_adjust``), the tensor-diffusion flux
``DiffFlux`` and the bank-free ``jacobian`` / ``hessian``.

On an axisymmetric (rz) mesh the operators carry the JAX package's rz
terms: the Laplacian's ``1 +- dr/(2r)`` radial vectors and their Neumann
RHS rows, the Div's ``2 dr / r`` centre term and its one-sided edge rows'
``adv phi / r``, and the ``r`` weight of ``DiffFlux``'s radial component;
each is zero at r = 0 (``nan_to_num``).
"""
from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from dataclasses import dataclass

import torch

from pyapes_tpu_torch.geometry.basis import n2d_coord
from pyapes_tpu_torch.parallel import blocks
from pyapes_tpu_torch.solver.tools import default_A_ops
from pyapes_tpu_torch.solver.types import DiscretizerConfigType
from pyapes_tpu_torch.variables import Field
from pyapes_tpu_torch.variables.bcs import BC
from pyapes_tpu_torch.variables.container import Hess, Jac


def tensor_idx(dim: int) -> list[tuple[int, int]]:
    """Upper-triangular index pairs (the JAX package's own copy of
    ``pymytools.indices.tensor_idx``)."""
    return [(i, j) for i in range(dim) for j in range(i, dim)]


def _row_sel(axis: int, idx, leading: int = 0) -> tuple:
    return (slice(None),) * (leading + axis) + (idx,)


def _take(a, i: int):
    """``a[i]`` with ``i`` clamped to the last entry: the JAX package's
    gathers clamp an out-of-range index (a scalar advector indexed by a
    vector target's component), where torch would raise."""
    return a[min(i, len(a) - 1)]


def _periodic_axes_of(var: Field) -> tuple[int, ...]:
    """Mesh axes on which ``var`` carries periodic BCs.

    The grid stores BOTH endpoints of a periodic axis (the duplicated seam
    node), so ``torch.roll`` on the full grid is NOT the periodic stencil:
    node 0's minus-neighbour is node ``n-2`` (node ``n-1`` IS node 0). The
    explicit appliers reduce and restore such an axis inside
    ``_A_coeff_var_sum``."""
    return tuple(sorted({bc.bc_face_dim for bc in (var.bcs or [])
                         if getattr(bc, "bc_type", None) == "periodic"}))


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

    def apply(self, A_coeffs, var: Field, edge: bool | None = None) -> torch.Tensor:
        """Apply the discretization. Output shape: Grad ``(var.dim,
        mesh.dim, *nx)``; Div ``(1, *nx)``; Laplacian ``(var.dim, *nx)``.
        ``edge`` None takes the config's ``edge`` (False without one)."""
        assert A_coeffs is not None, "FDC: A_coeffs is not defined!"
        if edge is None:
            if self.config is not None and self.op_type.lower() in self.config:
                edge = bool(self.config[self.op_type.lower()].get("edge", False))
            else:
                edge = False
                warnings.warn(f"FDC: config is not defined! Using default config ({edge=}).")

        v = var()
        # Periodic axes: exact torus stencils, and no one-sided edge rows
        # (the wrap rows are interior nodes of the torus)
        paxes = _periodic_axes_of(var)
        md = var.mesh.dim

        if self.op_type == "Grad":
            discretized = torch.stack([
                torch.stack([_A_coeff_var_sum(A_coeffs, v, idx, dim, var.dim, paxes)
                             for dim in range(md)])
                for idx in range(var.dim)
            ])
            if edge:
                for dim in range(discretized.shape[0]):
                    _treat_edge(discretized, var, self.op_type, dim, skip_axes=paxes)

        elif self.op_type == "Div":
            form = "conservative"
            if self.config is not None and "div" in self.config:
                form = self.config["div"].get("form", "conservative")
            acc = torch.zeros_like(v[0])
            for idx in range(md):
                disc = _A_coeff_var_sum(A_coeffs, v, idx, idx, var.dim, paxes)
                if edge and idx not in paxes:
                    _treat_edge(disc, var, self.op_type, idx, self.var_addition, form)
                acc = acc + disc
            discretized = acc[None]

        elif self.op_type == "Laplacian":
            # edge mode replaces each axis's contribution at that axis's
            # boundary slabs with the one-sided second derivative BEFORE
            # the sum over axes (the JAX package's rule)
            discretized = torch.zeros_like(v)
            for idx in range(var.dim):
                s = torch.zeros_like(v[0])
                for dim in range(md):
                    term = _A_coeff_var_sum(A_coeffs, v, idx, dim, var.dim, paxes)
                    if edge and dim not in paxes:
                        _one_sided_second_derivative(term, v[idx if var.dim > 1 else 0], dim,
                                                     float(var.mesh.dx_np[dim]))
                    s = s + term
                discretized[idx] = s
        else:
            raise TypeError(f"FDC: ({self.op_type=} is not supported!")

        return discretized

    def reset(self) -> None:
        self.A_coeffs = None
        self.rhs_adj = None

    def set_config(self, config: DiscretizerConfigType) -> None:
        self._config = config

    def __call__(self, *args, edge: bool | None = None):
        """Discretize ``var`` (Grad, Laplacian) or ``(var_j, var_i)``
        (Div); ``edge=`` overrides the config."""
        if len(args) == 1:
            assert isinstance(args[0], Field), "FDC: only `Field` is allowed for var!"
            var = args[0]
            self.A_coeffs = self._device_coeffs(var, (), lambda: self.build_A_coeffs(var))
            self.rhs_adj = self.adjust_rhs(var)
            return self.apply(self.A_coeffs, var, edge)
        var_j, var_i = args[0], args[1]
        assert isinstance(var_i, Field), "FDC: only `Field` is allowed for var_i!"
        build = lambda: self.build_A_coeffs(var_j, var_i, config=self.config)  # noqa: E731
        if isinstance(var_j, (int, float)) and not isinstance(var_j, bool):
            self.A_coeffs = self._device_coeffs(var_i, (float(var_j), repr(self.config)), build)
        else:  # per-point banks: built from the advector's values on every call
            self.A_coeffs = build()
        self.rhs_adj = self.adjust_rhs(var_j, var_i, config=self.config)
        self.var_addition = var_j
        return self.apply(self.A_coeffs, var_i, edge)

    def _device_coeffs(self, var: Field, key: tuple, build) -> "AxisCoeffs":
        """``build()``'s per-axis vectors as tensors on ``var``'s device in
        its dtype, kept by this operator object by what they are built from
        (grid, spacing, BC kinds, ``key``, dtype, device): an operator
        applied every step uploads its vectors once, not on every call (an
        upload from host memory waits for the card)."""
        x, mesh = var(), var.mesh
        key = (key, tuple(mesh.nx), tuple(float(d) for d in mesh.dx_np),
               tuple((bc.bc_face_dim, bc.bc_n_dir, bc.bc_type) for bc in var.bcs or []),
               x.dtype, x.device)
        cache = self.__dict__.setdefault("_vec_cache", {})
        if key not in cache:
            cache[key] = AxisCoeffs(
                tuple(torch.as_tensor(c, device=x.device).to(x.dtype) for c in cs)
                for cs in build().vecs)
        return cache[key]


class AxisCoeffs:
    """Separable explicit-stencil representation: per-axis 1-D coefficient
    vectors (host numpy from ``build_A_coeffs``; tensors on the field's
    device once an operator call uploads them) instead of five full-grid
    banks. Valid whenever the coefficients vary only along their own axis:
    the Laplacian and the Grad always, the Div with a constant advection."""

    def __init__(self, vecs):
        self.vecs = tuple(tuple(v) for v in vecs)


def _A_coeff_var_sum(A_coeffs, v: torch.Tensor, idx: int, dim: int, vdim: int,
                     paxes: tuple = ()) -> torch.Tensor:
    """Roll-sum of the stencil coefficients along mesh axis ``dim``
    (reference ``fdc.py:171-200``), from the ``AxisCoeffs`` vectors or the
    5-bank layout, in the same term order.

    On a periodic axis (``dim in paxes``) the sum runs on the reduced
    torus (the duplicate seam node dropped, where ``torch.roll`` IS the
    periodic stencil) and the duplicate output row is restored after it;
    coefficients on a periodic axis carry interior values at every node,
    so slicing their rows is exact. Returns a fresh tensor."""
    v_idx = 0 if vdim == 1 else idx
    vv = v[v_idx]
    periodic = dim in paxes
    red = _row_sel(dim, slice(None, -1))
    if periodic:
        vv = vv[red]  # of a block vector: a view on the torus' blocks
    summed = torch.zeros_like(vv)
    if isinstance(A_coeffs, AxisCoeffs):
        cs = A_coeffs.vecs[dim]
        offsets = (-1, 0, 1) if len(cs) == 3 else (-2, -1, 0, 1, 2)
        shape = [1] * vv.ndim
        shape[dim] = -1
        for c, off in zip(cs, offsets):
            c = torch.as_tensor(c, dtype=vv.dtype, device=vv.device)  # no copy once uploaded
            if periodic:
                c = c[:-1]
            shifted = torch.roll(vv, off, dim) if off else vv
            summed = summed + c.reshape(shape) * shifted
    else:
        assert len(A_coeffs) == 5, "FDC: the total number of coefficient tensors should be 5!"
        for i, c in enumerate(A_coeffs):
            coeff = c[dim][v_idx]
            if periodic:
                coeff = coeff[red]
            summed = summed + coeff * torch.roll(vv, -2 + i, dim)
    if periodic:  # the duplicate row restored (of a block vector: block by block)
        summed = blocks.append_seam(summed, dim)
    return summed


def _one_sided_second_derivative(term: torch.Tensor, v: torch.Tensor, axis: int,
                                 dx: float) -> torch.Tensor:
    """Overwrite, in place, the boundary slabs of a single-axis
    second-derivative field with the second-order one-sided formula
    ``(2 b - 5 b' + 4 b'' - b''') / dx^2`` (reference ``fdc.py:237-253``)."""
    for i0, i1, i2, i3 in ((0, 1, 2, 3), (-1, -2, -3, -4)):
        term[_row_sel(axis, i0)] = (
            2.0 * v[_row_sel(axis, i0)] - 5.0 * v[_row_sel(axis, i1)]
            + 4.0 * v[_row_sel(axis, i2)] - v[_row_sel(axis, i3)]
        ) / (dx**2)
    return term


def _div_edge_advector(var_add, var: Field, v: torch.Tensor, dim: int) -> torch.Tensor:
    """The advection the one-sided Div rows of axis ``dim`` multiply by."""
    n2d = n2d_coord(var.mesh.coord_sys)
    if isinstance(var_add, Field):
        return _take(var_add(), dim)
    if isinstance(var_add, Jac):
        return var_add[n2d[dim]]
    if isinstance(var_add, float):
        return torch.ones_like(_take(v, dim)) * var_add
    if var_add is None:
        return torch.ones_like(_take(v, dim))
    if isinstance(var_add, Hess):
        # tensor advection: the (component, axis) pair of this edge sweep
        i_comp = 0 if v.shape[0] == 1 else dim
        return var_add[n2d[i_comp] + n2d[dim]]
    if hasattr(var_add, "shape"):
        a = torch.as_tensor(var_add, dtype=v.dtype, device=v.device)
        return _take(a, dim) if a.shape == v.shape else a
    raise NotImplementedError(f"FDC: unsupported advector type {type(var_add)}")


def _treat_edge(discretized: torch.Tensor, var: Field, ops: str, dim: int, var_add=None,
                form: str = "conservative", skip_axes: tuple = ()) -> torch.Tensor:
    """One-sided second-order boundary rows of ``edge=True`` mode
    (reference ``fdc.py:203-366``), written into ``discretized`` in place.
    ``skip_axes``: periodic axes, whose wrap rows are torus-interior nodes
    already exact from the reduced-roll apply."""
    v = var()
    dx = var.mesh.dx_np
    sides = ((0, 1, 2, -1.0), (-1, -2, -3, 1.0))

    if ops == "Grad":
        for idx in range(var.mesh.dim):
            if idx in skip_axes:
                continue
            for i0, i1, i2, sgn in sides:
                b = v[dim][_row_sel(idx, i0)]
                bp = v[dim][_row_sel(idx, i1)]
                bpp = v[dim][_row_sel(idx, i2)]
                discretized[(dim, idx) + _row_sel(idx, i0)] = (
                    sgn * (1.5 * b - 2.0 * bp + 0.5 * bpp) / float(dx[idx]))

    elif ops == "Div":
        adv = _div_edge_advector(var_add, var, v, dim)
        target = v[0] if v.shape[0] == 1 else v[dim]
        # conservative: the one-sided derivative of the product adv*phi;
        # advective: the one-sided derivative of phi scaled by adv
        prod = adv * target if form == "conservative" else target
        for i0, i1, i2, sgn in sides:
            sel = _row_sel(dim, i0)
            b = prod[sel]
            bp = prod[_row_sel(dim, i1)]
            bpp = prod[_row_sel(dim, i2)]
            val = sgn * (1.5 * b - 2.0 * bp + 0.5 * bpp) / float(dx[dim])
            if form != "conservative":
                val = val * adv[sel]
            if var.mesh.coord_sys == "rz" and dim == 0:
                val = val + torch.nan_to_num(adv[sel] * target[sel] / var.mesh.R[sel],
                                             nan=0.0, posinf=0.0, neginf=0.0)
            discretized[sel] = val
    else:
        raise RuntimeError(f"FDC: edge treatment of {ops=} is not supported!")

    return discretized


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
        (the JAX package's rule; see its PARITY.md). A zero flux adds
        nothing and is skipped."""
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
                    if mesh.coord_sys == "rz":
                        dr = dx[j] if j == 0 else 0.0
                        r_row = float(mesh._x_np[j][pi])
                        s_row = dr / (2.0 * r_row) if r_row != 0.0 else 0.0
                    else:
                        s_row = 0.0
                    # the eliminated bank value: Am = 1 - s (lower) / Ap =
                    # 1 + s (upper); s = dr/(2r) in rz
                    c0 = 1.0 - s_row if bc.bc_n_dir < 0 else 1.0 + s_row
                    at_bc = _return_bc_val(bc, var, i, j, bi)
                    if _is_zero(at_bc):
                        continue
                    blocks.add_at(rhs_adj, (i,) + _row_sel(j, pi), torch.as_tensor(
                        -(2.0 / 3.0) * c0 * at_bc / dx[j], dtype=rhs_adj.dtype, device=rhs_adj.device
                    ))
        return rhs_adj


class Grad(Discretizer):
    r"""Gradient :math:`\nabla \Phi`, second-order central differences
    (reference ``fdc.py:461-502``). Output shape ``(var.dim, mesh.dim,
    *nx)``."""

    def __init__(self):
        self._op_type = __class__.__name__
        self._config = None
        self.A_coeffs = None
        self.rhs_adj = None

    @staticmethod
    def build_A_coeffs(var: Field, config=None) -> AxisCoeffs:
        from pyapes_tpu_torch.ops.stencil import grad_axis_coeffs

        return AxisCoeffs(grad_axis_coeffs(var.mesh, var.bcs, 1.0, dtype=var().dtype))

    @staticmethod
    def adjust_rhs(var: Field, config=None) -> torch.Tensor:
        rhs_adj = torch.zeros_like(var())
        if var.bcs is not None:
            for i in range(var.dim):
                rhs_adj = _grad_rhs_adjust(var, rhs_adj, i)
        return rhs_adj


def _is_zero(val) -> bool:
    return isinstance(val, float) and val == 0.0


def _grad_rhs_adjust(var: Field, rhs_adj: torch.Tensor, dim: int, gamma=None,
                     form: str = "conservative") -> torch.Tensor:
    """Neumann RHS adjustment shared by Grad/Div (reference
    ``fdc.py:475-518``): ``-c0 V / 3`` on the boundary-adjacent row, ``c0``
    the pre-``1/(2 dx)`` coefficient the surgery eliminates and ``V`` the
    outward-normal flux. ``gamma`` None (Grad: ``c0 = n``), ``(adv,)``
    (central Div: ``c0 = n adv`` at the boundary node, conservative, or at
    the row, advective) or ``(adv_min, adv_max)`` (upwind/QUICK: ``-2
    max`` lower, ``+2 min`` upper, at the row). Adds into ``rhs_adj`` in
    place and returns it; a zero flux adds nothing and is skipped."""
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
            if _is_zero(at_bc):
                continue
            if gamma is None:
                term = -(1.0 / 3.0) * at_bc * bc.bc_n_dir
            elif len(gamma) == 1:
                g_i = bi if form == "conservative" else pi
                term = -(1.0 / 3.0) * at_bc * bc.bc_n_dir * blocks.take(
                    gamma[0], (dim,) + _row_sel(j, g_i))
            else:
                g = gamma_max if bc.bc_n_dir < 0 else gamma_min
                term = -(1.0 / 3.0) * at_bc * bc.bc_n_dir * blocks.take(
                    g, (dim,) + _row_sel(j, pi))
            blocks.add_at(rhs_adj, (dim,) + _row_sel(j, pi), term)
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
                if _is_zero(at_bc):
                    continue
                a_row = blocks.take(adv, (j,) + _row_sel(j, pi))
                if limiter == "none":
                    term = -(1.0 / 3.0) * at_bc * bc.bc_n_dir * a_row
                else:
                    g = (torch.clamp(a_row, min=0.0) if bc.bc_n_dir < 0
                         else torch.clamp(a_row, max=0.0))
                    term = -(2.0 / 3.0) * at_bc * bc.bc_n_dir * g
                blocks.add_at(rhs_adj, (i,) + _row_sel(j, pi), term)
    return rhs_adj


def _grad_central_adjust(var: Field, A_ops: list, dim: int) -> list:
    """Boundary surgery of component ``dim`` of the central gradient /
    advection banks ``[Ap, Ac, Am]``, then the ``1/(2 dx)`` scaling
    (reference ``fdc.py:543-609``), in place on the banks.

    Neumann/Symmetry faces take the boundary-node elimination rule: the
    coefficient ``c0`` multiplying the boundary node moves ``+4/3 c0`` to
    the centre and ``-1/3 c0`` to the far neighbour (read from the banks'
    own values, so exact for a per-point advection and for upwind).
    Periodic faces take none: every node of the torus is interior."""
    Ap, Ac, Am = A_ops
    dx = var.mesh.dx_np
    for j in range(var.mesh.dim):
        for bc in _face_bcs(var, j):
            pi = 1 if bc.bc_n_dir < 0 else -2
            sel = (dim,) + _row_sel(j, pi)
            if bc.bc_type in ("neumann", "symmetry"):
                near, far = (Am, Ap) if bc.bc_n_dir < 0 else (Ap, Am)
                c0 = near[j][sel].clone()
                Ac[j][sel] += (4.0 / 3.0) * c0
                far[j][sel] += -(1.0 / 3.0) * c0
                near[j][sel] = 0.0
        for bank in (Ap, Ac, Am):
            bank[j][dim] = bank[j][dim] / (2.0 * float(dx[j]))
    return [Ap, Ac, Am]


class Div(Discretizer):
    r"""Divergence :math:`\partial_j (u_j \phi_i)` with the ``none``
    (central; ``form`` conservative or advective), ``upwind`` and
    ``quick`` schemes (reference ``fdc.py:612-694``): separable vectors for
    a constant advection, per-point banks for an array, ``Field``, ``Jac``
    or ``Hess`` advector."""

    def __init__(self):
        self._op_type = __class__.__name__
        self._config = None
        self.A_coeffs = None
        self.rhs_adj = None

    @staticmethod
    def build_A_coeffs(var_j, var_i: Field, config):
        assert config is not None and "div" in config, "FDC Div: config should contain 'div' key."
        limiter = _check_limiter(config["div"])
        if isinstance(var_j, (int, float)) and not isinstance(var_j, bool):
            from pyapes_tpu_torch.ops.stencil import div_axis_coeffs

            return AxisCoeffs(div_axis_coeffs(var_i.mesh, var_i.bcs, float(var_j), limiter,
                                              dtype=var_i().dtype))
        adv = var_j if isinstance(var_j, (Jac, Hess)) else _div_var_j_to_tensor(var_j, var_i)
        # private copies: default_A_ops shares one tensor between banks
        App, Ap, Ac, Am, Amm = ([t.clone() for t in bank] for bank in default_A_ops(var_i, "Div"))
        form = config["div"].get("form", "conservative")
        if limiter == "none":
            Ap, Ac, Am = _adv_central(adv, var_i, [Ap, Ac, Am], form)
        elif limiter == "upwind":
            Ap, Ac, Am = _adv_upwind(adv, var_i, [Ap, Ac, Am])
        elif limiter == "quick":
            App, Ap, Ac, Am, Amm = _adv_quick(adv, var_i, [App, Ap, Ac, Am, Amm])
        else:
            raise RuntimeError(f"FDC Div: {limiter=} is an unknown limiter type.")
        return [App, Ap, Ac, Am, Amm]

    @staticmethod
    def adjust_rhs(var_j, var_i: Field, config) -> torch.Tensor:
        """Neumann RHS correction of the Div (reference ``fdc.py:660-683``):
        central takes the advection at the boundary node (conservative) or
        at the row (advective); upwind and QUICK (upwind next to the faces)
        the split ``min``/``max`` parts."""
        rhs_adj = torch.zeros_like(var_i())
        if var_i.bcs and not isinstance(var_j, (Jac, Hess)):
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


def _advection(adv, var: Field, i: int, j: int) -> torch.Tensor:
    """The advection of target component ``i`` along mesh axis ``j``: for
    a ``Jac`` the flux component per mesh axis (scalar target) or per
    component; for a ``Hess`` the ``(i, j)`` entry; else component ``i``."""
    n2d = n2d_coord(var.mesh.coord_sys)
    if isinstance(adv, Jac):
        return adv[n2d[j if var.dim == 1 else i]]
    if isinstance(adv, Hess):
        return adv[n2d[i] + n2d[j]]
    return _take(adv, i)


def _adv_central(adv, var: Field, A_ops, form: str = "conservative") -> list:
    """Central-difference advection banks (reference ``fdc.py:708-743``):
    ``form="conservative"`` multiplies the neighbour coefficients by the
    rolled advection (flux form), ``"advective"`` by the local one."""
    Ap, Ac, Am = A_ops
    paxes = _periodic_axes_of(var)
    for i in range(var.dim):
        for j in range(var.mesh.dim):
            advection = _advection(adv, var, i, j)
            if form == "conservative":
                a_minus = torch.roll(advection, 1, j)
                if j in paxes:
                    # the duplicated-endpoint seam: the minus-neighbour of
                    # row 0 is row n-2 (roll grabs the duplicate row n-1)
                    a_minus[_row_sel(j, 0)] = advection[_row_sel(j, -2)]
                Ap[j][i] = Ap[j][i] * torch.roll(advection, -1, j)
                Am[j][i] = Am[j][i] * a_minus
            else:
                Ap[j][i] = Ap[j][i] * advection
                Am[j][i] = Am[j][i] * advection
            Ac[j][i] = Ac[j][i] * advection
        Ap, Ac, Am = _grad_central_adjust(var, [Ap, Ac, Am], i)
    return [Ap, Ac, Am]


def _adv_upwind(adv, var: Field, A_ops) -> list:
    """First-order upwind advection banks: ``gamma_max (phi_i -
    phi_{i-1})/dx + gamma_min (phi_{i+1} - phi_i)/dx`` (the JAX package's
    corrected scheme)."""
    Ap, Ac, Am = A_ops
    zeros = torch.zeros_like(var()[0])
    for i in range(var.dim):
        for j in range(var.mesh.dim):
            advection = _advection(adv, var, i, j)
            g_min = torch.minimum(advection, zeros)
            g_max = torch.maximum(advection, zeros)
            Ap[j][i] = 2.0 * g_min
            Ac[j][i] = 2.0 * (g_max - g_min) + Ac[j][i] * advection
            Am[j][i] = -2.0 * g_max
        Ap, Ac, Am = _grad_central_adjust(var, [Ap, Ac, Am], i)
    return [Ap, Ac, Am]


def _adv_quick(adv, var: Field, A_ops_all) -> list:
    """Third-order upwind-biased QUICK advection banks (the JAX package's
    scheme; reference ``fdc.py:659-660`` raises). Face interpolation,
    advective form, per unit ``1/dx``: ``gamma > 0``: ``(3 p+ + 3 p0 - 7 p-
    + p--)/8``; ``gamma < 0``: ``(-p++ + 7 p+ - 3 p0 - 3 p-)/8``. The
    boundary-adjacent rows fall back to first-order upwind; App/Amm are
    stored scaled (only the +-1 banks go through ``_grad_central_adjust``'s
    ``1/(2 dx)``)."""
    App, Ap, Ac, Am, Amm = A_ops_all
    zeros = torch.zeros_like(var()[0])
    dx = var.mesh.dx_np
    for i in range(var.dim):
        for j in range(var.mesh.dim):
            advection = _advection(adv, var, i, j)
            g_min = torch.minimum(advection, zeros)
            g_max = torch.maximum(advection, zeros)
            ac_base = Ac[j][i]
            ap_q = (3 * g_max + 7 * g_min) / 4.0
            ac_q = 3 * (g_max - g_min) / 4.0 + ac_base * advection
            am_q = -(7 * g_max + 3 * g_min) / 4.0
            app_q = -g_min / (8.0 * float(dx[j]))
            amm_q = g_max / (8.0 * float(dx[j]))
            ap_u = 2.0 * g_min
            ac_u = 2.0 * (g_max - g_min) + ac_base * advection
            am_u = -2.0 * g_max
            for idx in (1, -2):
                sel = _row_sel(j, idx)
                ap_q[sel] = ap_u[sel]
                ac_q[sel] = ac_u[sel]
                am_q[sel] = am_u[sel]
                app_q[sel] = 0.0
                amm_q[sel] = 0.0
            Ap[j][i] = ap_q
            Ac[j][i] = ac_q
            Am[j][i] = am_q
            App[j][i] = app_q
            Amm[j][i] = amm_q
        Ap, Ac, Am = _grad_central_adjust(var, [Ap, Ac, Am], i)
    return [App, Ap, Ac, Am, Amm]


def _div_var_j_to_tensor(var_j, var_i: Field) -> torch.Tensor:
    """The advecting argument as a tensor in ``var_i``'s dtype and device
    (reference ``fdc.py:775-792``)."""
    x = var_i()
    if isinstance(var_j, (int, float)) and not isinstance(var_j, bool):
        return torch.ones_like(x) * float(var_j)
    if isinstance(var_j, Field):
        return var_j()
    if isinstance(var_j, Jac):
        n2d = n2d_coord(var_i.mesh.coord_sys)
        return torch.stack([var_j[n2d[i]] for i in range(len(var_j))]).to(x.dtype)
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


class DiffFlux:
    r"""Tensor-diffusion flux :math:`D_{ij} \partial \Phi / \partial x_j`
    (reference ``fdc.py:820-857``) of a scalar ``Field`` and a ``Hess``:
    a vector ``Field`` with one component per mesh axis; in rz the radial
    component carries the ``r`` weight.

    The flux ``Field`` carries no BCs (``bc_config`` None), the JAX
    package's rule: a ``Field`` built with ``bc_config=None`` has an empty
    ``bcs`` list (only a dict without a ``"domain"`` entry raises)."""

    @staticmethod
    def __call__(diff: Hess, var: Field) -> Field:
        jac_var = jacobian(var)
        flux = Field("DiffFlux", len(jac_var), var.mesh, None)
        n2d = n2d_coord(var.mesh.coord_sys)
        for i in range(var.mesh.dim):
            diff_flux = torch.zeros_like(var()[0])
            for j in range(var.mesh.dim):
                d_coeff = diff[n2d[i] + n2d[j]]
                if n2d[i] == "r":
                    d_coeff = var.mesh.grid[0] * d_coeff
                diff_flux = diff_flux + d_coeff * jac_var[n2d[j]]
            flux.set_var_tensor(diff_flux, i)
        return flux


class FDC:
    """Facade over the explicit discretizers (reference ``fdc.py:860-893``);
    per-instance operator objects."""

    def __init__(self, config: DiscretizerConfigType | None = None):
        self.div = Div()
        self.laplacian = Laplacian()
        self.grad = Grad()
        self.diffFlux = DiffFlux()
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


def _grad_edge_1axis(v: torch.Tensor, dx: float, axis: int) -> torch.Tensor:
    """Central difference with second-order one-sided edges along one axis
    of a ``(*nx)`` tensor (the BC-free edge-mode gradient, no banks)."""
    d = (torch.roll(v, -1, axis) - torch.roll(v, 1, axis)) / (2.0 * dx)
    d[_row_sel(axis, 0)] = (-1.5 * v[_row_sel(axis, 0)] + 2.0 * v[_row_sel(axis, 1)]
                            - 0.5 * v[_row_sel(axis, 2)]) / dx
    d[_row_sel(axis, -1)] = (1.5 * v[_row_sel(axis, -1)] - 2.0 * v[_row_sel(axis, -2)]
                             + 0.5 * v[_row_sel(axis, -3)]) / dx
    return d


def jacobian(var: Field) -> Jac:
    """Jacobian of a scalar field by the edge-mode gradient (reference
    ``fdc.py:896-914``)."""
    assert var().shape[0] == 1, "Scalar: var must be a scalar field."
    n2d = n2d_coord(var.mesh.coord_sys)
    v = var()[0]
    dx = var.mesh.dx_np
    return Jac(**{n2d[i]: _grad_edge_1axis(v, float(dx[i]), i) for i in range(var.mesh.dim)})


def hessian(var: Field) -> Hess:
    """Hessian of a scalar field: the edge-mode gradient applied twice,
    the upper-triangular pairs kept (reference ``fdc.py:917-944``)."""
    indices = tensor_idx(var.mesh.dim)
    n2d = n2d_coord(var.mesh.coord_sys)
    v = var()[0]
    dx = var.mesh.dx_np
    md = var.mesh.dim
    jac = [_grad_edge_1axis(v, float(dx[i]), i) for i in range(md)]
    return Hess(**{n2d[i] + n2d[j]: _grad_edge_1axis(jac[i], float(dx[j]), j)
                   for i in range(md) for j in range(md) if (i, j) in indices})
