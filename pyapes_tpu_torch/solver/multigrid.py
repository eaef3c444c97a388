"""Geometric multigrid V-cycle preconditioner for the Krylov solvers
(PyTorch port of ``pyapes_tpu/solver/multigrid.py``).

The numerics are the JAX package's, and the host hierarchy (level shapes,
``1/dx^2``, surgered level coefficients, symmetrization scales, transfer
matrices) is built by the same numpy code, so it is bit-equal:

  * Levels by ~2x node coarsening (``_level_shapes``); the level operator
    is the central Laplacian rediscretized at that level's spacing,
    restricted to the interior, with the fine operator's Neumann/Symmetry
    boundary-node elimination at every level and the surgered rows scaled
    by 3/2 per axis (``_dvec_np``) so each level operator is SPD.
  * Damped Jacobi (or red-black Gauss-Seidel, or Chebyshev) smoothing,
    symmetric pre/post counts, so the cycle is an SPD preconditioner.
  * Endpoint-aligned per-axis transfers with the zero-flux boundary
    reconstruction folded in: per-axis matrix products (plain torch
    matmuls, as the JAX package leaves its tensordots to XLA), or O(n)
    slice ops on exactly-2x level pairs (``transfers="strided"``).
  * Singular (no-Dirichlet) hierarchies re-project each level RHS onto the
    zero-mean range (``_demean``).

The cycle runs in ``cycle_dtype`` (bf16 halves its memory traffic) while
the outer Krylov loop keeps the solve's dtype. On every 3-D level without
surgery the smooths and residuals go through the hand-written Hopper
kernels of ``ops/jacobi.py`` (CPU tensors take their plain versions), in
the JAX package's sequence: the double sweep for each pair of smooths,
the single sweep for an odd remainder and for residuals, and the
dot-emitting sweep for the last post-smooth when ``fuse_rz`` fuses the PCG
``dot(r, z)`` into the cycle. Surgered and 2-D levels apply the operator
through the axis-stencil kernel. The JAX package's TPU tiling gates are
not carried over: on the card every level shape takes the kernels.

All device constants of the hierarchy (masks, coefficient vectors,
diagonals, transfer matrices) are built once per spec and cached, so a
V-cycle makes no host-to-device copy — the PCG loop's only host sync
stays its tolerance read. Periodic axes, rz meshes, variable-Γ
hierarchies and domain decomposition are ported in later slices and
raise ``NotImplementedError``.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from pyapes_tpu_torch.mesh.tools import interior_mask_device
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil
from pyapes_tpu_torch.ops.jacobi import jacobi3d, jacobi3d_dot, jacobi3d_x2
from pyapes_tpu_torch.ops.stencil import _eliminate_boundary_node


@lru_cache(maxsize=None)
def _interp_matrix_np(n_c: int, n_f: int):
    """Endpoint-aligned 1-D linear interpolation matrix ``P`` of shape
    ``(n_f, n_c)``: row i samples the coarse hat functions at the fine
    vertex position ``i (n_c-1)/(n_f-1)`` (both grids include the domain
    endpoints)."""
    P = np.zeros((n_f, n_c), np.float64)
    for i in range(n_f):
        t = i * (n_c - 1) / (n_f - 1)
        j = min(int(np.floor(t)), n_c - 2)
        w = t - j
        P[i, j] += 1.0 - w
        P[i, j + 1] += w
    return P


def _level_shapes(shape, min_size=4, max_levels=8):
    shapes = [tuple(shape)]
    while len(shapes) < max_levels:
        nxt = tuple(max(3, (s + 1) // 2) for s in shapes[-1])
        if nxt == shapes[-1] or min(nxt) < min_size:
            break
        shapes.append(nxt)
    return shapes


# the kernels' mask axes: every axis of a 3-D level (no periodic axes yet)
_AXES3 = (0, 1, 2)


def _as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or its name ("bfloat16", "float32", ...)."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


class MGSpec:
    """Recipe and device constants of a multigrid preconditioner.

    Args:
        shape: active grid shape.
        lengths: physical domain length per axis.
        dtype: the outer (Krylov) dtype.
        cycle_dtype: V-cycle dtype (default: ``dtype``), e.g. "bfloat16".
        face_kinds: per axis ``(lower, upper)`` of "dirichlet"/"neumann".
        device: where the cycle runs.
        The other knobs are the JAX package's (``n_pre``, ``n_post``,
        ``n_coarse``, ``omega``, ``smoother``, ``fmg``, ``fmg_cycles``,
        ``fuse_rz``, ``transfers``).
    """

    def __init__(
        self,
        shape,
        lengths,
        paxes=(),
        dtype=torch.float32,
        n_pre: int = 2,
        n_post: int = 2,
        n_coarse: int = 24,
        omega: float = 2.0 / 3.0,
        rz: bool = False,
        cycle_dtype=None,
        smoother: str = "jacobi",
        fmg: bool = False,
        fmg_cycles: int = 1,
        fuse_rz: bool = False,
        decomp=None,
        face_kinds=None,
        var_gamma: bool = False,
        transfers: str = "strided",
        device="cpu",
    ):
        if paxes or rz or var_gamma or decomp is not None:
            raise NotImplementedError(
                "MGSpec: periodic axes, rz meshes, variable-Γ hierarchies and "
                "domain decomposition are ported in later slices"
            )
        assert transfers in ("matrix", "strided")
        assert smoother in ("jacobi", "rbgs", "chebyshev")
        self.shape = tuple(shape)
        self.lengths = tuple(float(l) for l in lengths)
        self.dtype = _as_torch_dtype(dtype)
        self.cdtype = _as_torch_dtype(cycle_dtype) if cycle_dtype else self.dtype
        self.n_pre = n_pre
        self.n_post = n_post
        self.n_coarse = n_coarse
        self.omega = omega
        self.smoother = smoother
        self.fmg_init = bool(fmg)
        self.fmg_cycles = int(fmg_cycles)
        self.fuse_rz = bool(fuse_rz)
        self.transfers = transfers
        self.device = torch.device(device)
        if face_kinds is None:
            face_kinds = tuple(("dirichlet", "dirichlet") for _ in self.shape)
        self.face_kinds = tuple(tuple(fk) for fk in face_kinds)
        self._surgery = any(k != "dirichlet" for fk in self.face_kinds for k in fk)
        # no Dirichlet face anywhere: every level operator is singular
        self._singular = all(
            all(k == "neumann" for k in fk) for fk in self.face_kinds
        )
        self.shapes = _level_shapes(self.shape)
        self._consts: dict = {}

    @property
    def key(self) -> tuple:
        """Everything the cycle depends on (the solver's cache key)."""
        return (
            self.shape, self.lengths, str(self.dtype), str(self.cdtype), self.n_pre,
            self.n_post, self.n_coarse, self.omega, self.smoother, self.fmg_init,
            self.fmg_cycles, self.fuse_rz, self.face_kinds, self.transfers, str(self.device),
        )

    # -- host hierarchy (numpy, bit-equal to the JAX package) -------------
    def _inv_dx2(self, shape):
        return [1.0 / (self.lengths[j] / (n - 1)) ** 2 for j, n in enumerate(shape)]

    def _surger(self, ap, ac, am, axis):
        """Boundary-node elimination on a level's numpy coefficient vectors
        (the fine operator's rule, rediscretized at every level)."""
        lo, up = self.face_kinds[axis]
        if lo == "neumann":
            _eliminate_boundary_node(ap, ac, am, True)
        if up == "neumann":
            _eliminate_boundary_node(ap, ac, am, False)

    def _level_coeffs_np(self, shape):
        inv = self._inv_dx2(shape)
        out = []
        for j, n in enumerate(shape):
            ap = inv[j] * np.ones(n)
            ac = -2.0 * inv[j] * np.ones(n)
            am = inv[j] * np.ones(n)
            self._surger(ap, ac, am, j)
            out.append((ap, ac, am))
        return tuple(out)

    def _dvec_np(self, n: int, axis: int):
        """Per-axis symmetrization row scale: 3/2 on the surgered rows,
        which makes the eliminated Neumann level operator symmetric."""
        d = np.ones(n)
        lo, up = self.face_kinds[axis]
        if lo == "neumann":
            d[1] = 1.5
        if up == "neumann":
            d[n - 2] = 1.5
        return d

    def _bc_extend_matrix_np(self, n: int, axis: int):
        """Boundary-reconstruction matrix ``E`` (n x n): identity on
        interior rows; Neumann/Symmetry boundary rows ``v_0 = 4/3 v_1 -
        1/3 v_2``, Dirichlet boundary rows 0."""
        E = np.eye(n)
        lo, up = self.face_kinds[axis]
        E[0, 0] = 0.0
        if lo == "neumann":
            E[0, 1] = 4.0 / 3.0
            E[0, 2] = -1.0 / 3.0
        E[n - 1, n - 1] = 0.0
        if up == "neumann":
            E[n - 1, n - 2] = 4.0 / 3.0
            E[n - 1, n - 3] = -1.0 / 3.0
        return E

    def _transfer_matrix_np(self, n_s: int, n_t: int, axis: int):
        """``(n_s, n_t)`` transfer matrix: ``(P E)^T`` when upsizing, the
        scaled transpose ``c (P E)`` (``c = (n_c-1)/(n_f-1)``) when
        downsizing — a symmetric pair, hence an SPD cycle."""
        if n_t > n_s:
            return (_interp_matrix_np(n_s, n_t) @ self._bc_extend_matrix_np(n_s, axis)).T
        return (
            _interp_matrix_np(n_t, n_s) @ self._bc_extend_matrix_np(n_t, axis)
        ) * ((n_t - 1) / (n_s - 1))

    # -- device constants (built once per spec, then cached) --------------
    def _const(self, key, make):
        if key not in self._consts:
            self._consts[key] = make()
        return self._consts[key]

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.cdtype, device=self.device)

    def _mask(self, shape):
        return self._const(("mask", shape), lambda: interior_mask_device(
            shape, (slice(1, -1),) * len(shape), self.cdtype, self.device)[None])

    def _n_act(self, shape) -> float:
        return float(np.prod([n - 2 for n in shape]))

    def _level_coeffs(self, shape):
        return self._const(("coeffs", shape), lambda: tuple(
            tuple(self._tensor(c).contiguous() for c in cs)
            for cs in self._level_coeffs_np(shape)))

    def _dfield(self, shape):
        """Broadcast product ``(1, *shape)`` of the per-axis scales."""
        def make():
            out = None
            for j, n in enumerate(shape):
                v = self._tensor(self._dvec_np(n, j)).reshape(
                    tuple(-1 if k == j else 1 for k in range(len(shape))))
                out = v if out is None else out * v
            return out[None]

        return self._const(("dfield", shape), make)

    def _diag(self, shape):
        """Jacobi diagonal: the interior scalar on unsurgered levels; the
        true diagonal ``D * sum_j ac_j / d_j`` of the scaled operator on
        surgered levels."""
        if not self._surgery:
            return -2.0 * sum(self._inv_dx2(shape))

        def make():
            coeffs = self._level_coeffs(shape)
            acc = None
            for j, n in enumerate(shape):
                ac = coeffs[j][1] / self._tensor(self._dvec_np(n, j))
                ac = ac.reshape(tuple(-1 if k == j else 1 for k in range(len(shape))))
                acc = ac if acc is None else acc + ac
            return self._dfield(shape) * acc[None]

        return self._const(("diag", shape), make)

    def _parity(self, shape):
        def make():
            ids = sum(
                torch.arange(n, device=self.device).reshape(
                    (1,) + tuple(-1 if k == j else 1 for k in range(len(shape))))
                for j, n in enumerate(shape)
            )
            return (ids % 2).expand((1, *shape))

        return self._const(("parity", shape), make)

    def _tmat(self, n_s, n_t, j):
        return self._const(("tmat", n_s, n_t, j),
                           lambda: self._tensor(self._transfer_matrix_np(n_s, n_t, j)))

    def _prepare(self) -> None:
        """Build every device constant the cycle reads, before the Krylov
        loop (a copy to the device inside the loop would be a sync)."""
        for lvl, shape in enumerate(self.shapes):
            self._mask(shape)
            self._level_coeffs(shape)
            if self._surgery:
                self._dfield(shape)
                self._diag(shape)
            if self.smoother == "rbgs":
                self._parity(shape)
            if lvl + 1 < len(self.shapes):
                for j, (nf, nc) in enumerate(zip(shape, self.shapes[lvl + 1])):
                    if nf != nc and not (self.transfers == "strided" and self._strided_ok(nf, nc)):
                        self._tmat(nf, nc, j)
                        self._tmat(nc, nf, j)

    # -- level operator and smoothers --------------------------------------
    def _kernels(self, shape) -> bool:
        """Whether the fused Jacobi kernels serve this level: they hard-code
        the plain 3-D central Laplacian."""
        return len(shape) == 3 and not self._surgery

    def _apply_A(self, x, shape):
        """Scaled level operator ``D A`` (``D = 1`` without surgery),
        through the axis-stencil kernel."""
        out = axis_stencil(self._level_coeffs(shape), x)
        if self._surgery:
            out = out * self._dfield(shape)
        return out

    def _fused(self, x, b, shape, alpha, beta):
        """``alpha x + beta mask (b - A x)`` through the Jacobi kernel on
        kernel levels; None otherwise."""
        if not self._kernels(shape):
            return None
        return jacobi3d(x, b, self._inv_dx2(shape), alpha, beta, _AXES3)

    def _color_update(self, x, b, shape, mask, par, color):
        r = (b - self._apply_A(x, shape)) * mask
        return x + torch.where(par == color, r / self._diag(shape), 0.0)

    def _rbgs_sweeps(self, x, b, shape, mask, n_iter, order):
        """Red-black Gauss-Seidel sweeps (two operator applies per sweep)."""
        par = self._parity(shape)
        for _ in range(n_iter):
            x = self._color_update(x, b, shape, mask, par, order)
            x = self._color_update(x, b, shape, mask, par, 1 - order)
        return x

    def _cheby_smooth(self, x, b, shape, mask, degree, x_is_zero=False):
        """Chebyshev polynomial smoothing on the Jacobi-scaled operator,
        targeting the upper 3/4 of its spectrum (``lmax = 1.95``)."""
        lmax = 1.95
        lmin = lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        dinv = 1.0 / self._diag(shape)

        if x_is_zero:
            z = dinv * (b * mask)
        else:
            z = dinv * self._residual(x, b, shape, mask)
        p = (1.0 / theta) * z
        x = x + p
        rho = 1.0 / sigma
        for _ in range(1, degree):
            rho_new = 1.0 / (2.0 * sigma - rho)
            z = dinv * self._residual(x, b, shape, mask)
            p = (rho_new * rho) * p + (2.0 * rho_new / delta) * z
            x = x + p
            rho = rho_new
        return x

    def _smooth(self, x, b, shape, mask, n_iter, order=0):
        if self.smoother == "chebyshev":
            return self._cheby_smooth(x, b, shape, mask, n_iter)
        if self.smoother == "rbgs":
            return self._rbgs_sweeps(x, b, shape, mask, n_iter, order)
        om_over_diag = self.omega / self._diag(shape)
        remaining = n_iter
        if remaining >= 2 and self._kernels(shape):
            while remaining >= 2:
                x = jacobi3d_x2(x, b, self._inv_dx2(shape), om_over_diag, _AXES3)
                remaining -= 2
        for _ in range(remaining):
            fused = self._fused(x, b, shape, 1.0, om_over_diag)
            if fused is not None:
                x = fused
            else:
                x = x + om_over_diag * ((b - self._apply_A(x, shape)) * mask)
        return x

    def _residual(self, x, b, shape, mask):
        fused = self._fused(x, b, shape, 0.0, 1.0)
        if fused is not None:
            return fused
        return (b - self._apply_A(x, shape)) * mask

    def _first_smooth(self, b, shape, mask, n_iter, order=0):
        """Smooth starting from x = 0: the first (half-)step is A-free."""
        if self.smoother == "chebyshev":
            return self._cheby_smooth(torch.zeros_like(b), b, shape, mask, n_iter, x_is_zero=True)
        if self.smoother == "rbgs":
            par = self._parity(shape)
            x = torch.where(par == order, b / self._diag(shape) * mask, 0.0)
            x = self._color_update(x, b, shape, mask, par, 1 - order)
            if n_iter > 1:
                x = self._rbgs_sweeps(x, b, shape, mask, n_iter - 1, order)
            return x
        if n_iter == 2 and self._kernels(shape):
            # fused pre-pair: (omega/D) b then one sweep, one memory pass
            return jacobi3d_x2(
                None, b, self._inv_dx2(shape), self.omega / self._diag(shape),
                _AXES3, from_zero=True,
            )
        x = (self.omega / self._diag(shape)) * b * mask
        if n_iter > 1:
            x = self._smooth(x, b, shape, mask, n_iter - 1)
        return x

    # -- transfers -----------------------------------------------------------
    def _strided_ok(self, n_s: int, n_t: int) -> bool:
        return n_s == 2 * n_t - 1 or n_t == 2 * n_s - 1

    @staticmethod
    def _ax_sel(x, j, sl):
        return x[(slice(None),) * (1 + j) + (sl,)]

    def _prolong_axis_strided(self, x, j, n_t):
        """``P E`` along axis j as slices: rebuild the boundary rows from
        the face BC, then interleave coarse values with midpoints."""
        ax = 1 + j
        sel = self._ax_sel
        lo, up = self.face_kinds[j]
        v0 = (
            (4.0 / 3.0) * sel(x, j, slice(1, 2)) - (1.0 / 3.0) * sel(x, j, slice(2, 3))
            if lo == "neumann" else torch.zeros_like(sel(x, j, slice(0, 1)))
        )
        vN = (
            (4.0 / 3.0) * sel(x, j, slice(-2, -1)) - (1.0 / 3.0) * sel(x, j, slice(-3, -2))
            if up == "neumann" else torch.zeros_like(sel(x, j, slice(-1, None)))
        )
        v = torch.cat([v0, sel(x, j, slice(1, -1)), vN], dim=ax)
        a = sel(v, j, slice(None, -1))
        mid = 0.5 * (a + sel(v, j, slice(1, None)))
        body = torch.stack([a, mid], dim=ax + 1).reshape(
            x.shape[:ax] + (n_t - 1,) + x.shape[ax + 1:]
        )
        return torch.cat([body, sel(v, j, slice(-1, None))], dim=ax)

    def _restrict_axis_strided(self, x, j, n_t):
        """``c E^T P^T`` along axis j as slices (c = 1/2 for exactly-2x):
        full weighting, then fold the boundary row's mass per the face BC."""
        ax = 1 + j
        sel = self._ax_sel
        pre = (slice(None),) * ax
        even = sel(x, j, slice(0, None, 2))
        odd = sel(x, j, slice(1, None, 2))
        out = 0.5 * even
        out[pre + (slice(1, None),)] += 0.25 * odd
        out[pre + (slice(None, -1),)] += 0.25 * odd
        lo, up = self.face_kinds[j]
        # snapshot the boundary masses BEFORE any fold
        w_lo = sel(out, j, slice(0, 1)).clone()
        w_up = sel(out, j, slice(-1, None)).clone()
        if lo == "neumann":
            out[pre + (slice(1, 2),)] += (4.0 / 3.0) * w_lo
            out[pre + (slice(2, 3),)] += (-1.0 / 3.0) * w_lo
        if up == "neumann":
            out[pre + (slice(-2, -1),)] += (4.0 / 3.0) * w_up
            out[pre + (slice(-3, -2),)] += (-1.0 / 3.0) * w_up
        out[pre + (slice(0, 1),)] = 0.0
        out[pre + (slice(-1, None),)] = 0.0
        return out

    def _resize(self, x, shape):
        """Per-axis transfers to ``shape``: O(n) slices on exactly-2x
        pairs with ``transfers="strided"``, matrix products (in the cycle
        dtype) otherwise. Returns a contiguous tensor."""
        for j, n_t in enumerate(shape):
            n_s = x.shape[1 + j]
            if n_s == n_t:
                continue
            if self.transfers == "strided" and self._strided_ok(n_s, n_t):
                x = (
                    self._prolong_axis_strided(x, j, n_t)
                    if n_t > n_s
                    else self._restrict_axis_strided(x, j, n_t)
                )
                continue
            x = self._contract(x, self._tmat(n_s, n_t, j), j)
        return x.contiguous()

    @staticmethod
    def _contract(x, M, j):
        """Contract axis ``1 + j`` of a contiguous ``x`` with ``M`` (n_s,
        n_t) without moving data: ``x @ M`` on the last axis, ``M^T x``
        batched over the leading axes otherwise (a tensordot would permute
        the grid to make the axis last, and back)."""
        n_s, n_t = M.shape
        if j + 2 == x.ndim:
            out = x.reshape(-1, n_s) @ M
        else:
            out = torch.matmul(M.t(), x.reshape(int(np.prod(x.shape[:1 + j])), n_s, -1))
        return out.reshape(x.shape[:1 + j] + (n_t,) + x.shape[2 + j:])

    # -- cycles ----------------------------------------------------------------
    def _demean(self, v, mask, shape):
        """Project a level RHS onto the singular operator's zero-mean
        range; identity for nonsingular hierarchies."""
        if not self._singular:
            return v
        m = torch.sum(v * mask, dim=tuple(range(1, v.ndim)), keepdim=True) / self._n_act(shape)
        return (v - m) * mask

    def _vcycle(self, b, level):
        shape = self.shapes[level]
        mask = self._mask(shape)
        b = self._demean(b * mask, mask, shape)
        if level == len(self.shapes) - 1:
            return self._first_smooth(b, shape, mask, self.n_coarse)
        # pre-smooths red-first, post-smooths black-first (symmetric cycle)
        x = self._first_smooth(b, shape, mask, self.n_pre, order=0)
        r = self._residual(x, b, shape, mask)
        e_c = self._vcycle(self._resize(r, self.shapes[level + 1]), level + 1)
        x = torch.addcmul(x, self._resize(e_c, shape), mask)
        return self._smooth(x, b, shape, mask, self.n_post, order=1)

    def can_fuse_rz(self) -> bool:
        """Whether the dot-emitting level-0 post-smooth serves the PCG
        ``dot(r, z)``: the kernels hard-code the unsurgered 3-D stencil, and
        the fused cycle has a coarse level (a one-level hierarchy is a
        plain coarse smooth)."""
        return (
            self.fuse_rz and self.smoother == "jacobi" and self.n_post >= 1
            and self._kernels(self.shape) and len(self.shapes) > 1
        )

    def _vcycle_dot(self, b):
        """Level-0 V-cycle whose final post-smooth also emits
        ``sum(b * out)``. Requires ``can_fuse_rz()``."""
        shape = self.shapes[0]
        mask = self._mask(shape)
        b = self._demean(b * mask, mask, shape)
        x = self._first_smooth(b, shape, mask, self.n_pre, order=0)
        r = self._residual(x, b, shape, mask)
        e_c = self._vcycle(self._resize(r, self.shapes[1]), 1)
        x = torch.addcmul(x, self._resize(e_c, shape), mask)
        inv = self._inv_dx2(shape)
        beta = self.omega / self._diag(shape)
        if self.n_post % 2 == 0:
            # final PAIR fused into one memory pass, dot included
            if self.n_post > 2:
                x = self._smooth(x, b, shape, mask, self.n_post - 2, order=1)
            return jacobi3d_x2(x, b, inv, beta, _AXES3, emit_dot=True)
        if self.n_post > 1:
            # regular post-smooths first; the LAST one emits the dot
            x = self._smooth(x, b, shape, mask, self.n_post - 1, order=1)
        return jacobi3d_dot(x, b, inv, 1.0, beta, _AXES3)

    def fmg(self, b, n_cycles: int = 1):
        """Full-multigrid pass: restrict b through the hierarchy, solve on
        the coarsest level, then prolong upward with ``n_cycles`` V-cycle
        corrections per level (an initial guess, ~1.15 V-cycles)."""
        L = len(self.shapes)
        bs = [b]
        for lvl in range(1, L):
            bs.append(self._resize(bs[-1], self.shapes[lvl]))
        shape = self.shapes[-1]
        mask = self._mask(shape)
        x = self._first_smooth(self._demean(bs[-1] * mask, mask, shape), shape, mask, self.n_coarse)
        for lvl in range(L - 2, -1, -1):
            shape = self.shapes[lvl]
            mask = self._mask(shape)
            x = self._resize(x, shape) * mask
            bl = self._demean(bs[lvl] * mask, mask, shape)
            for _ in range(n_cycles):
                x = x + self._vcycle(self._residual(x, bl, shape, mask), lvl)
        return x

    def fmg_initializer(self):
        """``dx = F(r0)`` (same cast shell as the preconditioner)."""
        self._prepare()

        def init(r):
            return self.fmg(r.to(self.cdtype), self.fmg_cycles).to(r.dtype)

        return init

    def preconditioner(self):
        """``z = P(r)``: one V-cycle. A low-precision cycle casts the
        residual directly (floating point is scale-invariant, and bf16 has
        f32's exponent range)."""
        self._prepare()

        def precond(r):
            return self._vcycle(r.to(self.cdtype), 0).to(r.dtype)

        return precond

    def preconditioner_dot(self):
        """``(z, rz) = P(r)`` with ``rz = sum(r * z)`` computed inside the
        final post-smooth kernel (``can_fuse_rz`` required); ``rz`` shaped
        ``(vdim, 1, ..., 1)``."""
        assert self.can_fuse_rz()
        self._prepare()

        def precond(r):
            z, dots = self._vcycle_dot(r.to(self.cdtype))
            return z.to(r.dtype), dots.to(r.dtype)

        return precond
