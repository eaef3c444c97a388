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

Variable-Γ hierarchies (``var_gamma``, the heterogeneous-diffusivity
operator ``∂_j (Γ ∂_j e)``): ``set_gamma`` samples the fine Γ down the
levels and keeps each level's Γ; it runs once per solve call, before the
Krylov loop, so a new Γ on a cached spec takes effect at once. Every
level applies through the ``ops/diff_field.py`` kernels (``diff_field``;
Jacobi smooth, first smooth from zero and residual through
``diff_jacobi``, which rebuilds the diagonal in registers), on 2-D and
3-D levels, isotropic or stacked Γ. A level's per-point diagonal field
is built at its first use in a call: only the rbgs and Chebyshev
smoothers read it (XLA drops it unread in the JAX package). The fixed
3/2 Neumann row scale does not apply (the surgered rows are
Γ-dependent), and neither do the constant-coefficient Jacobi kernels nor
the fused ``dot(r, z)``.

Under a domain decomposition (``decomp``, the JAX package's rules) the
fused Jacobi kernels, the double sweep and the fused ``dot(r, z)`` are
off: every smooth and residual applies the level operator, and a level
whose blocks pass ``parallel.halo.sharded_supported`` applies it block by
block through the halo-extended kernel (``make_sharded_apply``); coarser
levels take the global axis-stencil kernel. Variable-Γ hierarchies drop
a view-based decomposition (their levels apply on the whole tensor).

Under a placed decomposition (blocks on their own devices) a level where
``parallel.halo.placed_supported`` holds keeps its vectors as block
vectors (``parallel.blocks.BlockTensor``): its mask, row scales, diagonal
and parity are built block by block on each block's device (never from a
whole-level tensor), its operator applies block by block, and the
smoothers' elementwise work runs per block. A transfer between two placed
levels runs block by block too (``_transfer_axis``): along an uncut axis
each block resizes its own rows; along a cut axis each block's output
rows come from its own rows and the few ghost rows of its neighbours that
the transfer's band reaches (``halo.line_rows``, ``transfer_ghost_bytes``)
— a slice of the banded transfer matrix per block, or the strided wrap
midpoints of a torus pair. The levels the gate rejects run on the solve's
device: the hand-over from the coarsest placed level to them is the one
gather of a V-cycle (counted in ``blocks.gathers``), the way back a
scatter. A variable-Γ hierarchy keeps a placed decomposition: ``set_gamma``
samples Γ down the placed levels block by block (the fine Γ is never
gathered; the coarsest placed level's is, once per call, for the levels
below it: ``gamma_gathers``), and a level that ``placed_field_supported``
takes applies and smooths block by block (``halo.placed_diff_field``,
``placed_diff_jacobi``). ``vcycles``, ``cycle_gathers`` and
``fmg_gathers`` count the preconditioner's V-cycles and the gathers inside
them and inside the FMG starts.

All device constants of the hierarchy (masks, coefficient vectors,
diagonals, transfer matrices) are built once per spec and cached, so a
V-cycle makes no host-to-device copy — the PCG loop's only host sync
stays its tolerance read.

Axisymmetric (rz) hierarchies (``rz``, ``r_lower``): each level's radial
vectors carry the ``1 +- dr/(2r)`` terms rediscretized at the level's
spacing, with the same per-level surgery (the JAX package's
``_rz_axis_coeffs``); every level applies through the axis-stencil kernel
(2-D: the per-point kernel), and the smoother stays the plain update
around it, as the JAX package keeps its rz smoother off Pallas. The level
operators are nonsymmetric, so rz hierarchies precondition BiCGSTAB.

Periodic axes (``paxes``, on the torus-reduced grid: n nodes span [0, L)
with n cells) take no surgery and a full mask, the stencils wrap, the
transfers are the wrap-aware interpolation pair (strided on exact 2x
torus pairs: wrap midpoints), and the Jacobi kernels mask only the other
axes (``_mask_axes``). A box with no Dirichlet face off its periodic axes
is singular.
"""
from __future__ import annotations

from functools import lru_cache
from math import prod

import numpy as np
import torch

from pyapes_tpu_torch.mesh.tools import interior_mask_device
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil
from pyapes_tpu_torch.ops.diff_field import diff_field, diff_jacobi
from pyapes_tpu_torch.ops.jacobi import jacobi3d, jacobi3d_dot, jacobi3d_x2
from pyapes_tpu_torch.ops.stencil import _eliminate_boundary_node, diff_diag
from pyapes_tpu_torch.parallel import blocks
from pyapes_tpu_torch.parallel.decomp import DomainDecomposition
from pyapes_tpu_torch.parallel.halo import (
    line_rows,
    make_sharded_apply,
    placed_diff_diag,
    placed_diff_field,
    placed_diff_jacobi,
    placed_field_supported,
    placed_supported,
    sharded_supported,
)

vcycles = 0
"""V-cycles run as a preconditioner (a counter)."""
cycle_gathers = 0
"""``blocks.gathers`` made inside those V-cycles (a counter)."""
fmg_gathers = 0
"""``blocks.gathers`` made inside full-multigrid starts (a counter)."""
gamma_gathers = 0
"""``blocks.gathers`` made by ``set_gamma``: the coarsest placed level's Γ
handed to the levels on the solve's device (a counter)."""


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


@lru_cache(maxsize=None)
def _interp_matrix_periodic_np(n_c: int, n_f: int):
    """Wrap-aware 1-D linear interpolation matrix of a torus axis: the
    active nodes ``i L/n`` span ``[0, L)``, so the sampling positions and
    the neighbour index wrap modulo the period."""
    P = np.zeros((n_f, n_c), np.float64)
    for i in range(n_f):
        t = i * n_c / n_f
        j = int(np.floor(t))
        w = t - j
        P[i, j % n_c] += 1.0 - w
        P[i, (j + 1) % n_c] += w
    return P


def _level_shapes(shape, min_size=4, max_levels=8):
    shapes = [tuple(shape)]
    while len(shapes) < max_levels:
        nxt = tuple(max(3, (s + 1) // 2) for s in shapes[-1])
        if nxt == shapes[-1] or min(nxt) < min_size:
            break
        shapes.append(nxt)
    return shapes


def _as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or its name ("bfloat16", "float32", ...)."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


class MGSpec:
    """Recipe and device constants of a multigrid preconditioner.

    Args:
        shape: active grid shape (after the periodic de-duplication).
        lengths: physical domain length per axis.
        paxes: periodic axes (wrap stencils, full mask, no surgery).
        dtype: the outer (Krylov) dtype.
        cycle_dtype: V-cycle dtype (default: ``dtype``), e.g. "bfloat16".
        face_kinds: per axis ``(lower, upper)`` of "dirichlet"/"neumann".
        device: where the cycle runs: the device of the solve's vectors
            (required; there is no default device); under a placed
            decomposition, the lead device of its blocks.
        decomp: a ``DomainDecomposition`` (blocks as views on ``device``,
            or placed on their own devices), or None.
        var_gamma: variable-Γ level operators (``set_gamma`` before the
            cycle), with ``vg_avg`` ("arithmetic"/"harmonic") face values.
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
        r_lower: float = 0.0,
        cycle_dtype=None,
        smoother: str = "jacobi",
        fmg: bool = False,
        fmg_cycles: int = 1,
        fuse_rz: bool = False,
        decomp=None,
        face_kinds=None,
        var_gamma: bool = False,
        vg_avg: str = "arithmetic",
        transfers: str = "strided",
        *,
        device,
    ):
        if decomp is not None:
            if not isinstance(decomp, DomainDecomposition):
                raise TypeError(f"MGSpec: decomp must be a DomainDecomposition, got {decomp!r}")
            decomp.check_device(device)
        assert transfers in ("matrix", "strided")
        assert smoother in ("jacobi", "rbgs", "chebyshev")
        assert vg_avg in ("arithmetic", "harmonic")
        self.var_gamma = bool(var_gamma)
        self.vg_avg = vg_avg
        if self.var_gamma:
            assert not rz, "var_gamma MG: rz meshes not supported"
            fuse_rz = False  # the dot kernels hard-code the constant stencil
            if decomp is not None and not decomp.placed:
                decomp = None  # the Γ levels apply on the whole tensor
        self.rz = bool(rz)
        self.r_lower = float(r_lower)
        if self.rz:
            fuse_rz = False  # the dot kernels hard-code the Cartesian stencil
        self.decomp = decomp
        self._sharded_applies: dict = {}
        self._layouts: dict = {}
        self._g_levels = None
        self._gd_levels = None
        self._gb_levels = None
        self._field_buffers: dict = {}
        self.shape = tuple(shape)
        self.lengths = tuple(float(l) for l in lengths)
        self.paxes = tuple(paxes or ())
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
        self._surgery = any(k != "dirichlet" for j, fk in enumerate(self.face_kinds)
                            if j not in self.paxes for k in fk)
        # no Dirichlet face off the periodic axes: every level is singular
        self._singular = all(j in self.paxes or all(k == "neumann" for k in fk)
                             for j, fk in enumerate(self.face_kinds))
        self.shapes = _level_shapes(self.shape)
        self._consts: dict = {}

    @property
    def key(self) -> tuple:
        """Everything the cycle depends on (the solver's cache key)."""
        return (
            self.shape, self.lengths, self.paxes, str(self.dtype), str(self.cdtype), self.n_pre,
            self.n_post, self.n_coarse, self.omega, self.smoother, self.fmg_init,
            self.fmg_cycles, self.fuse_rz, self.face_kinds, self.transfers, str(self.device),
            self.var_gamma, self.vg_avg, self.decomp, self.rz, self.r_lower,
        )

    # -- host hierarchy (numpy, bit-equal to the JAX package) -------------
    def _inv_dx2(self, shape):
        """Per-axis ``1/dx^2``: a periodic axis spans [0, L) with n cells,
        the others [0, L] with n - 1."""
        return [1.0 / (self.lengths[j] / (n if j in self.paxes else n - 1)) ** 2
                for j, n in enumerate(shape)]

    def _mask_axes(self, shape) -> tuple:
        """The axes whose end rows the Jacobi kernels mask: all but the
        periodic ones."""
        return tuple(j for j in range(len(shape)) if j not in self.paxes)

    def _surger(self, ap, ac, am, axis):
        """Boundary-node elimination on a level's numpy coefficient vectors
        (the fine operator's rule, rediscretized at every level; none on a
        periodic axis)."""
        if axis in self.paxes:
            return
        lo, up = self.face_kinds[axis]
        if lo == "neumann":
            _eliminate_boundary_node(ap, ac, am, True)
        if up == "neumann":
            _eliminate_boundary_node(ap, ac, am, False)

    def _level_coeffs_np(self, shape):
        """Per-axis level vectors with the per-level surgery; on rz the
        radial axis carries ``1 +- dr/(2r)`` at the level's spacing (the
        JAX package's ``_rz_axis_coeffs``), zero at r = 0."""
        inv = self._inv_dx2(shape)
        out = []
        for j, n in enumerate(shape):
            if self.rz and j == 0:
                dr = 1.0 / np.sqrt(inv[0])
                r = self.r_lower + dr * np.arange(n)
                with np.errstate(divide="ignore", invalid="ignore"):
                    s = np.nan_to_num(dr / (2.0 * r), nan=0.0, posinf=0.0, neginf=0.0)
                ap = (1.0 + s) * inv[0]
                ac = -2.0 * np.ones(n) * inv[0]
                am = (1.0 - s) * inv[0]
            else:
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
        if axis in self.paxes:
            return d
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
        downsizing — a symmetric pair, hence an SPD cycle. A torus axis takes
        the wrap-aware pair (no boundary, no ``E``)."""
        if axis in self.paxes:
            if n_t > n_s:
                return _interp_matrix_periodic_np(n_s, n_t).T
            return _interp_matrix_periodic_np(n_t, n_s) * (n_t / n_s)
        if n_t > n_s:
            return (_interp_matrix_np(n_s, n_t) @ self._bc_extend_matrix_np(n_s, axis)).T
        return (
            _interp_matrix_np(n_t, n_s) @ self._bc_extend_matrix_np(n_t, axis)
        ) * ((n_t - 1) / (n_s - 1))

    # -- variable-Γ levels (per solve call) -------------------------------
    def _vg_surgery(self):
        """Per-axis ``(lower, upper)`` kinds of the variable-Γ level
        operators: the face kinds, Dirichlet read as "none"; a periodic axis
        is a plain wrap ("none", "none")."""
        return tuple(
            ("none", "none") if j in self.paxes
            else tuple("neumann" if k == "neumann" else "none" for k in fk)
            for j, fk in enumerate(self.face_kinds)
        )

    def _downsample_g(self, g, shape_t):
        """Restrict a level's Γ to the next level by endpoint-aligned linear
        SAMPLING (exact subsampling on vertex-aligned 2x levels): a
        coefficient field is sampled, not full-weighted like a residual.
        Stacked ``(dim, *shape)`` Γ keeps its leading axis."""
        iso = g.ndim == len(shape_t)
        g = g[None] if iso else g
        for j, n_t in enumerate(shape_t):
            n_s = g.shape[1 + j]
            if n_s != n_t:
                g = self._contract(g.contiguous(), self._sample_mat(n_s, n_t, j), j)
        return g[0] if iso else g

    def _sample_np(self, n_s, n_t, j):
        """``(n_s, n_t)`` sampling matrix ``P^T`` (host, float64) of
        ``_downsample_g`` along axis j: endpoint-aligned, wrap-aware on a
        periodic axis."""
        interp = _interp_matrix_periodic_np if j in self.paxes else _interp_matrix_np
        return interp(n_s, n_t).T

    def _sample_mat(self, n_s, n_t, j):
        """``_sample_np`` in the cycle dtype on the solve's device."""
        return self._const(("gsample", n_s, n_t, j in self.paxes),
                           lambda: self._tensor(self._sample_np(n_s, n_t, j)))

    def set_gamma(self, gamma) -> None:
        """The solver's ``precond_setup`` hook: cast the fine Γ to the
        cycle dtype, sample it down the hierarchy and keep every level's Γ
        (each level's diagonal is built at its first use, ``_diag``).
        Device work only, once per solve call before the Krylov loop, so a
        new Γ on a cached spec is used at once. On placed levels Γ is a
        block vector ``(1 | dim, *shape)`` sampled down block by block
        (``_transfer_axis``); the coarsest placed level's is gathered once
        (``gamma_gathers``) for the levels below it."""
        assert self.var_gamma
        lay0 = self._placement(self.shape)
        if lay0 is not None and not isinstance(gamma, blocks.BlockTensor):
            raise ValueError("MGSpec.set_gamma: a placed hierarchy takes Γ on its blocks")
        iso = False
        if isinstance(gamma, blocks.BlockTensor):
            iso = gamma.shape[0] == 1 and gamma.dim() == len(self.shape) + 1
            g = gamma.to(self.cdtype)
        else:
            g = torch.as_tensor(gamma, device=self.device).to(self.cdtype).contiguous()

        def on_lead(gl):
            """A level's Γ block vector handed to the levels on the lead
            device (counted), an isotropic one as ``(*shape)``."""
            global gamma_gathers
            g0 = blocks.gathers
            gl = blocks.gather(gl)
            gamma_gathers += blocks.gathers - g0
            return gl[0] if iso else gl

        levels = [on_lead(g) if lay0 is None and isinstance(g, blocks.BlockTensor) else g]
        for shape in self.shapes[1:]:
            prev = levels[-1]
            if isinstance(prev, blocks.BlockTensor) and self._placement(shape) is not None:
                levels.append(self._resize_blocks(prev, shape, self._sample_np))
            else:
                levels.append(self._downsample_g(
                    on_lead(prev) if isinstance(prev, blocks.BlockTensor) else prev, shape))
        self._g_levels = levels
        self._gd_levels = [None] * len(levels)
        self._gb_levels = [gl if isinstance(gl, blocks.BlockTensor) else None for gl in levels]

    def _gamma(self, shape):
        if self._g_levels is None:
            raise RuntimeError("MGSpec: set_gamma was not called before the cycle")
        return self._g_levels[self.shapes.index(tuple(shape))]

    def _gamma_blocks(self, shape):
        """A placed level's Γ block vector (``set_gamma``), else None."""
        self._gamma(shape)
        return self._gb_levels[self.shapes.index(tuple(shape))]

    def _vg_pass(self, x, b, shape, mode):
        """One ``diff_jacobi`` pass ("smooth", "smooth0" or "resid"); on a
        placed level block by block (``halo.placed_diff_jacobi``)."""
        args = (self._inv_dx2(shape), self._vg_surgery(), self.vg_avg, self.omega,
                self._mask_axes(shape), mode)
        gb = self._gamma_blocks(shape)
        if gb is not None:
            return placed_diff_jacobi(x, b, gb, *args, self._field_buffers)
        return diff_jacobi(x, b, self._gamma(shape), *args)

    # -- device constants (built once per spec, then cached) --------------
    def _const(self, key, make):
        if key not in self._consts:
            self._consts[key] = make()
        return self._consts[key]

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.cdtype, device=self.device)

    def _placement(self, shape):
        """The ``blocks.Layout`` of a placed level (a placed decomposition
        whose block-wise apply takes the level: ``placed_supported``, or
        ``placed_field_supported`` for the variable-Γ levels), else None."""
        shape = tuple(shape)
        if self.decomp is None or not self.decomp.placed:
            return None
        if shape not in self._layouts:
            ok = (placed_field_supported(self.decomp, shape, self.paxes) if self.var_gamma
                  else placed_supported(self.decomp, shape))
            self._layouts[shape] = blocks.layout(self.decomp, shape, self.device) if ok else None
        return self._layouts[shape]

    def _on_level(self, v, shape):
        """``v`` in the level's form: scattered to a placed level, gathered
        (counted) for a level on the solve's device (a plain ``v`` there
        comes back as it is)."""
        lay = self._placement(shape)
        if lay is not None:
            return blocks.scatter(v, lay)
        return blocks.gather(v)

    def _mask(self, shape):
        """The level's active nodes: the interior, every node of a periodic
        axis."""
        slicer = tuple(slice(None) if j in self.paxes else slice(1, -1)
                       for j in range(len(shape)))
        lay = self._placement(shape)
        if lay is not None:
            return self._const(("mask", shape), lambda: blocks.interior_mask(
                lay, slicer, self.cdtype))
        return self._const(("mask", shape), lambda: interior_mask_device(
            shape, slicer, self.cdtype, self.device)[None])

    def _n_act(self, shape) -> float:
        return float(np.prod([n if j in self.paxes else n - 2 for j, n in enumerate(shape)]))

    def _level_coeffs(self, shape):
        return self._const(("coeffs", shape), lambda: tuple(
            tuple(self._tensor(c).contiguous() for c in cs)
            for cs in self._level_coeffs_np(shape)))

    def _per_block(self, shape, make):
        """``make(sl, device)`` (``sl`` the index ranges, one slice per axis)
        on the solve's device over the whole level, or block by block on a
        placed level (``blocks.build``: no whole-level tensor)."""
        lay = self._placement(shape)
        if lay is None:
            return make(tuple(slice(0, n) for n in shape), self.device)
        return blocks.build(lay, make)

    def _axis_vec(self, a, j, sl, dev, ndim):
        """The per-axis vector ``a`` (host) cut to ``sl[j]``, in the cycle
        dtype on ``dev``, broadcastable along axis j of an ``ndim`` grid."""
        return self._tensor(a)[sl[j]].to(dev).reshape(
            tuple(-1 if k == j else 1 for k in range(ndim)))

    def _dfield(self, shape):
        """Broadcast product ``(1, *shape)`` of the per-axis scales."""
        def make(sl, dev):
            out = None
            for j, n in enumerate(shape):
                v = self._axis_vec(self._dvec_np(n, j), j, sl, dev, len(shape))
                out = v if out is None else out * v
            return out.expand(tuple(s.stop - s.start for s in sl))[None].contiguous()

        return self._const(("dfield", shape), lambda: self._per_block(shape, make))

    def _diag(self, shape):
        """Jacobi diagonal: the interior scalar on unsurgered levels; the
        true diagonal ``D * sum_j ac_j / d_j`` of the scaled operator on
        surgered levels; under ``var_gamma`` the true per-point diagonal
        of the level's Γ operator (the kernels' in-register one), in the
        cycle dtype, built at its first use after ``set_gamma``."""
        if self.var_gamma:
            g = self._gamma(shape)
            lvl = self.shapes.index(tuple(shape))
            if self._gd_levels[lvl] is None:
                args = (self._inv_dx2(shape), self._vg_surgery(), self.vg_avg)
                self._gd_levels[lvl] = (
                    placed_diff_diag(g, *args, self.paxes)
                    if isinstance(g, blocks.BlockTensor) else diff_diag(g, *args)
                ).to(self.cdtype)
            return self._gd_levels[lvl]
        if not self._surgery:
            return -2.0 * sum(self._inv_dx2(shape))

        def make(sl, dev):
            acc = None
            for j, n in enumerate(shape):
                ac = (self._axis_vec(self._level_coeffs_np(shape)[j][1], j, sl, dev, len(shape))
                      / self._axis_vec(self._dvec_np(n, j), j, sl, dev, len(shape)))
                acc = ac if acc is None else acc + ac
            return acc[None]

        return self._const(("diag", shape),
                           lambda: self._dfield(shape) * self._per_block(shape, make))

    def _om_diag(self, shape):
        """``omega / diag``, the damped-Jacobi weight: a device constant of
        the level where the diagonal is one (a Γ-free surgered level), the
        scalar or a per-call tensor otherwise."""
        if self.var_gamma or not self._surgery:
            return self.omega / self._diag(shape)
        return self._const(("om_diag", shape), lambda: self.omega / self._diag(shape))

    def _parity(self, shape):
        def make(sl, dev):
            ids = sum(
                torch.arange(s.start, s.stop, device=dev).reshape(
                    (1,) + tuple(-1 if k == j else 1 for k in range(len(shape))))
                for j, s in enumerate(sl)
            )
            return (ids % 2).expand((1, *(s.stop - s.start for s in sl))).contiguous()

        return self._const(("parity", shape), lambda: self._per_block(shape, make))

    def _tmat(self, n_s, n_t, j):
        return self._const(("tmat", n_s, n_t, j),
                           lambda: self._tensor(self._transfer_matrix_np(n_s, n_t, j)))

    def _prepare(self) -> None:
        """Build every device constant the cycle reads, before the Krylov
        loop (a copy to the device inside the loop would be a sync)."""
        for lvl, shape in enumerate(self.shapes):
            self._mask(shape)
            if not self.var_gamma:  # Γ levels are per call (set_gamma)
                self._level_coeffs(shape)
                if self._surgery:
                    self._dfield(shape)
                    self._diag(shape)
            if self.smoother == "rbgs":
                self._parity(shape)
            if lvl + 1 < len(self.shapes):
                for j, (nf, nc) in enumerate(zip(shape, self.shapes[lvl + 1])):
                    if nf != nc and self.var_gamma:
                        self._sample_mat(nf, nc, j)
                    if nf != nc and not (self.transfers == "strided"
                                         and self._strided_ok(nf, nc, j)):
                        self._tmat(nf, nc, j)
                        self._tmat(nc, nf, j)
                if self._placement(self.shapes[lvl + 1]) is not None \
                        and self._placement(shape) is not None:
                    self._prepare_transfers(shape, self.shapes[lvl + 1])

    def _prepare_transfers(self, fine, coarse) -> None:
        """Build the block-wise transfers' plans and device constants between
        two placed levels (both directions; Γ's sampling down too), so no
        cycle copies one from the host."""
        mats = [(None, fine, coarse), (None, coarse, fine)]
        if self.var_gamma:
            mats.append((self._sample_np, fine, coarse))
        for mat, src, dst in mats:
            lay = self._placement(src)
            for j, n_t in enumerate(dst):
                if lay.grid[j] != n_t:
                    lay = self._transfer_plan(lay, j, n_t, mat)[0]

    # -- level operator and smoothers --------------------------------------
    def _kernels(self, shape) -> bool:
        """Whether the fused Jacobi kernels serve this level: they hard-code
        the plain 3-D central Laplacian, and a decomposed cycle applies the
        operator block-wise instead."""
        return (len(shape) == 3 and not self._surgery and not self.var_gamma
                and self.decomp is None)

    def _sharded_apply(self, shape):
        """The block-wise apply of this level, or None (no decomposition,
        or blocks the gate rejects)."""
        if self.decomp is None:
            return None
        if shape not in self._sharded_applies:
            gate = placed_supported if self.decomp.placed else sharded_supported
            self._sharded_applies[shape] = (
                make_sharded_apply(self.decomp, len(shape))
                if gate(self.decomp, shape) else None)
        return self._sharded_applies[shape]

    def _apply_A(self, x, shape):
        """Scaled level operator ``D A`` (``D = 1`` without surgery),
        through the axis-stencil kernel; the variable-Γ operator (unscaled)
        through the diff-field kernel."""
        if self.var_gamma:
            args = (self._inv_dx2(shape), self._vg_surgery(), self.vg_avg)
            gb = self._gamma_blocks(shape)
            if gb is not None:
                return placed_diff_field(x, gb, *args, self.paxes, self._field_buffers)
            return diff_field(x, self._gamma(shape), *args)
        sharded = self._sharded_apply(tuple(shape))
        coeffs = self._level_coeffs(shape)
        out = sharded(coeffs, x) if sharded is not None else axis_stencil(coeffs, x)
        if self._surgery:
            out = out * self._dfield(shape)
        return out

    def _fused(self, x, b, shape, alpha, beta):
        """``alpha x + beta mask (b - A x)`` through the Jacobi kernel on
        kernel levels; None otherwise."""
        if not self._kernels(shape):
            return None
        return jacobi3d(x, b, self._inv_dx2(shape), alpha, beta, self._mask_axes(shape))

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
        if self.var_gamma:
            for _ in range(n_iter):
                x = self._vg_pass(x, b, shape, "smooth")
            return x
        om_over_diag = self._om_diag(shape)
        remaining = n_iter
        if remaining >= 2 and self._kernels(shape):
            while remaining >= 2:
                x = jacobi3d_x2(x, b, self._inv_dx2(shape), om_over_diag,
                                self._mask_axes(shape))
                remaining -= 2
        for _ in range(remaining):
            fused = self._fused(x, b, shape, 1.0, om_over_diag)
            if fused is not None:
                x = fused
            else:
                x = x + om_over_diag * ((b - self._apply_A(x, shape)) * mask)
        return x

    def _residual(self, x, b, shape, mask):
        if self.var_gamma:
            return self._vg_pass(x, b, shape, "resid")
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
        if self.var_gamma:
            x = self._vg_pass(None, b, shape, "smooth0")
            if n_iter > 1:
                x = self._smooth(x, b, shape, mask, n_iter - 1)
            return x
        if n_iter == 2 and self._kernels(shape):
            # fused pre-pair: (omega/D) b then one sweep, one memory pass
            return jacobi3d_x2(
                None, b, self._inv_dx2(shape), self._om_diag(shape),
                self._mask_axes(shape), from_zero=True,
            )
        x = self._om_diag(shape) * b * mask
        if n_iter > 1:
            x = self._smooth(x, b, shape, mask, n_iter - 1)
        return x

    # -- transfers -----------------------------------------------------------
    def _strided_ok(self, n_s: int, n_t: int, axis: int) -> bool:
        """Exactly-2x pairs: vertex-aligned ``n_f = 2 n_c - 1``, on a torus
        axis wrap-aligned ``n_f = 2 n_c``."""
        if axis in self.paxes:
            return n_s == 2 * n_t or n_t == 2 * n_s
        return n_s == 2 * n_t - 1 or n_t == 2 * n_s - 1

    @staticmethod
    def _ax_sel(x, j, sl):
        return x[(slice(None),) * (1 + j) + (sl,)]

    def _prolong_axis_strided(self, x, j, n_t):
        """``P E`` along axis j as slices: rebuild the boundary rows from
        the face BC, then interleave coarse values with midpoints (a torus
        axis: the wrap midpoint, no boundary rows)."""
        ax = 1 + j
        sel = self._ax_sel
        if j in self.paxes:
            mid = 0.5 * (x + torch.roll(x, -1, ax))
            return torch.stack([x, mid], dim=ax + 1).reshape(
                x.shape[:ax] + (n_t,) + x.shape[ax + 1:])
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
        full weighting, then fold the boundary row's mass per the face BC
        (a torus axis: wrapped full weighting, no fold)."""
        ax = 1 + j
        sel = self._ax_sel
        pre = (slice(None),) * ax
        even = sel(x, j, slice(0, None, 2))
        odd = sel(x, j, slice(1, None, 2))
        if j in self.paxes:
            return 0.5 * even + 0.25 * odd + 0.25 * torch.roll(odd, 1, ax)
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
        dtype) otherwise. Returns a contiguous tensor in the target level's
        form: between two placed levels block by block
        (``_resize_blocks``); from a placed level to one on the solve's
        device through one counted gather (the hand-over), back through a
        scatter (``_on_level``)."""
        if isinstance(x, blocks.BlockTensor) and self._placement(shape) is not None:
            return self._resize_blocks(x, shape)
        x = blocks.gather(x)
        for j, n_t in enumerate(shape):
            n_s = x.shape[1 + j]
            if n_s == n_t:
                continue
            if self.transfers == "strided" and self._strided_ok(n_s, n_t, j):
                x = (
                    self._prolong_axis_strided(x, j, n_t)
                    if n_t > n_s
                    else self._restrict_axis_strided(x, j, n_t)
                )
                continue
            x = self._contract(x, self._tmat(n_s, n_t, j), j)
        return self._on_level(x.contiguous(), shape)

    def _resize_blocks(self, x, shape, mat=None):
        """``_resize`` (``mat`` None) or ``_downsample_g`` (``mat`` the
        sampling matrices, ``_sample_np``) of a block vector of a placed
        level to the placed level ``shape``, axis by axis
        (``_transfer_axis``); the result is a block vector of that level."""
        for j, n_t in enumerate(shape):
            if x.shape[1 + j] != n_t:
                x = self._transfer_axis(x, j, n_t, mat)
        return x

    def _transfer_axis(self, x, j, n_t, mat=None):
        """The transfer of the block vector ``x`` along grid axis ``j`` to
        ``n_t`` nodes, block by block on each block's device (the grid's
        other axes keep their extents, so every intermediate is a block
        vector of the same decomposition), as ``_transfer_plan`` says."""
        to, grid, steps = self._transfer_plan(x.placement, j, n_t, mat)
        parts = []
        for b, (kind, data) in enumerate(steps):
            xb = x.parts[b]
            if kind == "strided":
                ob = (self._prolong_axis_strided(xb, j, n_t) if n_t > xb.shape[1 + j]
                      else self._restrict_axis_strided(xb, j, n_t))
            elif kind == "matrix":
                ob = self._contract(xb.contiguous(), data, j)
            elif kind == "torus":
                ob = self._strided_rows(x, b, j, n_t, *data)
            else:  # "band"
                ranges, M = data
                ob = self._contract(line_rows(x, b, j, ranges).contiguous(), M, j)
            parts.append(ob.contiguous())
        return blocks.BlockTensor(parts, to, (x.shape[0], *grid))

    def _transfer_plan(self, lay, j, n_t, mat=None):
        """``(target layout, its grid, per block (kind, data))`` of the
        transfer of a block vector of ``lay`` along grid axis ``j`` to
        ``n_t`` nodes (``mat``: the sampling matrices of Γ, else the
        transfers'), made once: along an uncut axis each block's whole-axis
        transfer ("strided" slices, or its "matrix" product); along a cut
        axis a torus pair's strided wrap midpoints ("torus", the block's
        output rows; ``_strided_rows``), else the block's slice of the
        banded matrix against the rows its band reaches ("band", ``_band``,
        ``halo.line_rows``). A strided pair that is not a torus pair never
        has both levels placed (its fine axis has an odd node count), so
        the matrix of the same map serves it there."""
        def make():
            n_s = lay.grid[j]
            grid = lay.grid[:j] + (n_t,) + lay.grid[j + 1:]
            to = blocks.layout(self.decomp, grid, self.device)
            mat_np = mat or self._transfer_matrix_np
            strided = mat is None and self.transfers == "strided" and self._strided_ok(n_s, n_t, j)
            steps = []
            for b, (_, _, dev) in enumerate(lay.blocks):
                sl = to.blocks[b][1][j]
                if not lay.cut[j]:
                    steps.append(("strided", None) if strided
                                 else ("matrix", self._dev_mat(mat_np, n_s, n_t, j, dev)))
                elif strided and j in self.paxes:
                    steps.append(("torus", (sl.start, sl.stop)))
                else:
                    steps.append(("band", self._band(mat_np, n_s, n_t, j, sl.start, sl.stop,
                                                     dev)))
            return to, grid, tuple(steps)

        return self._const(("transfer", lay, j, n_t, mat is None), make)

    def _dev_mat(self, mat_np, n_s, n_t, j, dev):
        """A whole transfer (or sampling) matrix in the cycle dtype on
        ``dev`` (the values of ``_tmat`` / ``_sample_mat``)."""
        return torch.as_tensor(mat_np(n_s, n_t, j), dtype=self.cdtype, device=dev)

    def _band(self, mat_np, n_s, n_t, j, t0, t1, dev):
        """``(ranges, M)``: the source rows the columns ``t0:t1`` of the
        ``(n_s, n_t)`` matrix read, as ascending ``(lo, hi)`` runs, and those
        rows of those columns in the cycle dtype on ``dev`` (the same
        entries as the whole matrix, so a block's product adds the same
        terms in the same order)."""
        sub = np.asarray(mat_np(n_s, n_t, j))[:, t0:t1]
        rows = np.nonzero(np.any(sub != 0.0, axis=1))[0]
        cuts = np.nonzero(np.diff(rows) != 1)[0] + 1
        ranges = tuple((int(r[0]), int(r[-1]) + 1) for r in np.split(rows, cuts) if len(r))
        return ranges, torch.as_tensor(sub[rows], dtype=self.cdtype, device=dev)

    def _strided_rows(self, x, b, j, n_t, t0, t1):
        """Rows ``t0:t1`` of the strided transfer of a torus axis ``j`` for
        block ``b`` of ``x``, from the rows they read (``halo.line_rows``,
        wrapping), with the whole-axis forms' operations in their order:
        the prolongation ``x[k]`` and ``0.5 (x[k] + x[k+1])``, the
        restriction ``0.5 x[2t] + 0.25 x[2t+1] + 0.25 x[2t-1]``."""
        ax = 1 + j
        if n_t > x.shape[ax]:  # prolong: n_t = 2 n_s
            k0, k1 = t0 // 2, (t1 - 1) // 2
            v = line_rows(x, b, j, ((k0, k1 + 2),))
            a = v.narrow(ax, 0, k1 - k0 + 1)
            mid = 0.5 * (a + v.narrow(ax, 1, k1 - k0 + 1))
            out = torch.stack([a, mid], dim=ax + 1).reshape(
                a.shape[:ax] + (2 * (k1 - k0 + 1),) + a.shape[ax + 1:])
            return out.narrow(ax, t0 - 2 * k0, t1 - t0)
        v = line_rows(x, b, j, ((2 * t0 - 1, 2 * t1),))
        sel = self._ax_sel
        even = sel(v, j, slice(1, None, 2))
        return 0.5 * even + 0.25 * sel(v, j, slice(2, None, 2)) \
            + 0.25 * sel(v, j, slice(0, -1, 2))

    @staticmethod
    def _contract(x, M, j):
        """Contract axis ``1 + j`` of a contiguous ``x`` with ``M`` (n_s,
        n_t) without moving data: ``x @ M`` on the last axis, ``M^T x``
        batched over the leading axes otherwise (a tensordot would permute
        the grid to make the axis last, and back)."""
        n_s, n_t = M.shape
        if j + 2 == x.ndim:
            out = torch.mm(x.reshape(-1, n_s), M)
        else:
            # mm / bmm called directly: matmul's broadcasting adds a handful
            # of host-side ops per call, and a placed level makes one call
            # per block and axis
            lead = prod(x.shape[:1 + j])
            xr = x.reshape(lead, n_s, -1)
            out = (torch.mm(M.t(), xr[0]) if lead == 1
                   else torch.bmm(M.t().expand(lead, n_t, n_s), xr))
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
        b = self._on_level(b, shape)
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
        ``dot(r, z)``: the kernels hard-code the unsurgered constant-Γ 3-D
        stencil, and the fused cycle has a coarse level (a one-level
        hierarchy is a plain coarse smooth)."""
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
        beta = self._om_diag(shape)
        if self.n_post % 2 == 0:
            # final PAIR fused into one memory pass, dot included
            if self.n_post > 2:
                x = self._smooth(x, b, shape, mask, self.n_post - 2, order=1)
            return jacobi3d_x2(x, b, inv, beta, self._mask_axes(shape), emit_dot=True)
        if self.n_post > 1:
            # regular post-smooths first; the LAST one emits the dot
            x = self._smooth(x, b, shape, mask, self.n_post - 1, order=1)
        return jacobi3d_dot(x, b, inv, 1.0, beta, self._mask_axes(shape))

    def fmg(self, b, n_cycles: int = 1):
        """Full-multigrid pass: restrict b through the hierarchy, solve on
        the coarsest level, then prolong upward with ``n_cycles`` V-cycle
        corrections per level (an initial guess, ~1.15 V-cycles)."""
        L = len(self.shapes)
        bs = [self._on_level(b, self.shapes[0])]
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
            global fmg_gathers
            g0 = blocks.gathers
            x = _like(self.fmg(r.to(self.cdtype), self.fmg_cycles).to(r.dtype), r)
            fmg_gathers += blocks.gathers - g0
            return x

        return init

    def preconditioner(self):
        """``z = P(r)``: one V-cycle. A low-precision cycle casts the
        residual directly (floating point is scale-invariant, and bf16 has
        f32's exponent range)."""
        self._prepare()

        def precond(r):
            global vcycles, cycle_gathers
            g0 = blocks.gathers
            z = _like(self._vcycle(r.to(self.cdtype), 0).to(r.dtype), r)
            vcycles += 1
            cycle_gathers += blocks.gathers - g0
            return z

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


def _like(z, r):
    """The cycle's output ``z`` in the form of its input ``r``: scattered
    to ``r``'s blocks, or gathered (counted) for a plain ``r``."""
    if isinstance(r, blocks.BlockTensor):
        return blocks.scatter(z, r.placement)
    return blocks.gather(z)
