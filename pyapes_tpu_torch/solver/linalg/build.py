"""Solver assembly (port of ``pyapes_tpu/solver/linalg.py::_build_solver``
and ``_make_mg_spec``): the active-set mask, the operator over the stencil
and advection kernels, the eigen-factors and refinement loop of fastdiag,
and the CG/BiCGSTAB loops with the multigrid preconditioner (Γ-aware for
variable-Γ terms, streamed in by ``precond_setup``) or the
fast-diagonalization preconditioner (its equation scalars streamed the
same way), the symmetrizing row scale of Neumann faces and the fused
operator/preconditioner dots.

Under a domain decomposition (the JAX package's ``_select_kernel_tiers``
without its TPU-only clauses) the 3-point axis terms apply block by block
wherever ``sharded_supported`` holds, the central/upwind Div and Conv
terms where ``sharded_advect_supported`` holds, and the fused alpha-dot is
off; everything else (5-point axes, the variable-Γ apply, ddt, the
fastdiag transforms and the FD preconditioner) runs on the whole tensor,
which is what GSPMD computes for it. The fastdiag residual uses the same
operator, so a decomposed fastdiag solve applies it block-wise too.

Under a placed decomposition (``decomp.placed``: blocks on their own
devices, the loop vectors ``parallel.blocks.BlockTensor``) the 3-point
axis terms apply block by block wherever ``placed_supported`` holds, the
central/upwind Div and Conv where ``sharded_advect_supported`` holds, the
variable-Γ term where ``placed_field_supported`` holds (Γ and the
advector arrive scattered to the blocks, ``dispatch._place_operands``),
each through one counted gather on the lead device elsewhere (QUICK, 5-point
axes, an ``fdm.custom`` term); the Γ-aware V-cycle samples Γ down block by
block; the active-set mask is built block by block (an obstacle's cells
cut from its mask per block), the BCs write the face rows of the blocks on
their faces (an obstacle its cells, a Neumann body's shells from sources
the neighbouring blocks send), and the symmetrizing row scale, the null
vector of a singular system and a Neumann body's affine shift are block
vectors too; the fastdiag solve and the FD preconditioner transform the
block vectors in pencil layouts (``FastDiag.solve_blocks``). An obstacle
system's V-cycle is the plain domain's, placed or not: the Krylov loop
masks its output."""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from pyapes_tpu_torch.backend import np_dtype
from pyapes_tpu_torch.mesh.tools import interior_mask_device
from pyapes_tpu_torch.ops.advect import advect_pair, conv_component
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil, axis_stencil_dot
from pyapes_tpu_torch.ops.diff_field import diff_field
from pyapes_tpu_torch.parallel import blocks
from pyapes_tpu_torch.parallel.halo import (
    make_sharded_advect_apply,
    make_sharded_apply,
    placed_diff_field,
    placed_field_supported,
    placed_supported,
    sharded_advect_supported,
    sharded_supported,
)
from pyapes_tpu_torch.solver.fastdiag import FastDiag, FDPrecond, axis_matrix_np, fd_options
from pyapes_tpu_torch.solver.linalg.bicgstab_loop import build_bicgstab
from pyapes_tpu_torch.solver.linalg.cg_loop import build_cg
from pyapes_tpu_torch.solver.linalg.fastdiag_loop import build_fastdiag
from pyapes_tpu_torch.solver.multigrid import MGSpec
from pyapes_tpu_torch.utils.device_cache import device_array
from pyapes_tpu_torch.variables.bcs import apply_bcs_fn

# Multigrid hierarchies by their key (shape, knobs, dtypes, device): their
# device constants (masks, transfer matrices) are built once and reused by
# every solve of the same structure. Bounded LRU.
_MG_CACHE: OrderedDict = OrderedDict()
_MG_CACHE_MAX = 8
# Eigen-factors by CONTENT: the per-axis matrices' bytes, dtype and device
# are all they depend on, so a time-stepping or repeated solve (a new dt
# included: it streams through the symbol) re-factorizes nothing. Bounded
# LRU.
_FD_CACHE: OrderedDict = OrderedDict()
_FD_CACHE_MAX = 16


_OBSTACLE = ("obstacle_dirichlet", "obstacle_neumann")


class _MaskSpec:
    """Recipe for the 0/1 active-set mask, materialized on the device per
    solve call: the interior of ``slicer`` without the cells of the static
    obstacle BCs ``static`` (each keeps its mask on the device) and
    without the cells of the dynamic obstacles at ``dyn_idxs``, whose
    masks arrive per call in ``bc_vals`` (JAX ``linalg.py:39-63``). With
    ``layout`` (a placed decomposition): a block vector ``(1, *nx)`` built
    block by block, each static body's cut kept on its block's device, a
    dynamic body's mask a block vector of the call (``dispatch``)."""

    def __init__(self, nx, slicer, dtype, device, static=(), dyn_idxs=(), layout=None):
        self.nx, self.slicer, self.dtype, self.device = nx, slicer, dtype, device
        self.static = tuple(static)
        self.dyn_idxs = tuple(dyn_idxs)
        self.layout = layout

    def build(self, bc_vals=()) -> torch.Tensor:
        if self.layout is not None:
            m = blocks.interior_mask(self.layout, self.slicer, self.dtype)
            for bc in self.static:
                for p, bm in zip(m.parts, bc.block_mask(self.layout).parts):
                    p.masked_fill_(bm, 0.0)
        else:
            m = interior_mask_device(self.nx, self.slicer, self.dtype, self.device)
            for bc in self.static:
                m = m.masked_fill(bc.mask_on(self.device), 0.0)
        for i in self.dyn_idxs:
            if bc_vals and bc_vals[i] is not None:
                m = m * (1.0 - bc_vals[i][0].to(m.dtype))
        return m


def _custom(fn, x, params):
    return fn(x, *params)


def _make_Aop(term_descs, stencil_fn=axis_stencil, advect_fns=None,
              field_fn=diff_field, custom_fn=_custom) -> Callable:
    """``Aop(x, tparams) = sum_terms sign * term(x)``: an axis term is
    ``param * stencil_fn(x)`` (a 5-point axis goes to the 5-point kernel),
    a variable-Γ term ``field_fn`` (``diff_field``), a per-point advection
    term ``advect_pair`` (Div) or ``conv_component`` (Conv) — or
    ``advect_fns[i]`` for term ``i`` where given (the block-wise apply) —
    a custom term ``custom_fn(fn, x, params)`` (``fn(x, *params)``) and a
    ddt term ``x * inv_dt``: the
    Hopper kernels on a CUDA tensor, for every grid shape (the JAX
    package's "auto" gate used its kernels only for TPU-aligned shapes). A Div's ``(1, *nx)`` contribution broadcasts
    over the components, as in the JAX package."""
    advect_fns = advect_fns or {}

    def Aop(x, tparams):
        out = None
        for i, ((kind, _, sign, has_param, surgery, form, limiter), tp) in enumerate(
                zip(term_descs, tparams)):
            scale = sign
            if kind == "ddt":
                r, scale = x, sign * tp["inv_dt"]
            elif kind == "custom":
                r = custom_fn(tp["fn"], x, tp["cparams"])
            elif kind == "diff_field":
                r = field_fn(x, tp["gamma"], form[0], surgery, form[1])
            elif i in advect_fns:
                r = advect_fns[i](x, tp["adv"], tp["base"])
            elif kind == "div_field":
                r = advect_pair(x, tp["adv"], tp["base"], limiter, surgery, form)
            elif kind == "conv_field":
                r = conv_component(x, tp["adv"], tp["base"], limiter, surgery)
            else:
                r = stencil_fn(tp["axis"], x)
                if has_param:
                    scale = sign * tp["param"]
            if scale != 1.0:
                r = r * scale
            out = r if out is None else out + r
        if out.shape == x.shape:
            return out
        if isinstance(x, blocks.BlockTensor):  # broadcast block by block
            return torch.zeros_like(x) + out
        return out.expand(x.shape).contiguous()

    return Aop


def _placed_fns(decomp, x0, term_descs, paxes) -> dict:
    """The placed applies of a solve on block vectors, as ``_make_Aop``
    keywords: the axis stencil block by block where ``placed_supported``
    holds (and the axes are 3-point), the central/upwind Div and Conv
    where ``sharded_advect_supported`` holds, the variable-Γ apply where
    ``placed_field_supported`` holds (``paxes``: the torus' periodic
    axes); each of the others, and an ``fdm.custom`` term (an opaque
    function), through one counted gather on the lead device, the
    operands' lead copies beside it (``blocks.lead_copy``)."""
    shape = tuple(x0.shape[1:])
    blockwise = (make_sharded_apply(decomp, len(shape))
                 if placed_supported(decomp, shape) else None)

    def stencil_fn(coeffs, x):
        if blockwise is None or any(len(cs) == 5 for cs in coeffs):
            return blocks.via_lead(lambda v: axis_stencil(coeffs, v), x)
        return blockwise(coeffs, x)

    def via_lead_advect(d):
        kernel = advect_pair if d[0] == "div_field" else conv_component
        args = (d[6], d[4], d[5]) if d[0] == "div_field" else (d[6], d[4])

        def apply(x, adv, base):
            return blocks.via_lead(lambda v: kernel(v, blocks.lead_copy(adv), base, *args), x)

        return apply

    advect_fns = {}
    for i, d in enumerate(term_descs):
        if d[0] in ("div_field", "conv_field"):
            advect_fns[i] = (make_sharded_advect_apply(
                decomp, "div" if d[0] == "div_field" else "conv", x0.shape[0], d[6], d[4], d[5])
                if sharded_advect_supported(decomp, shape, d[6]) else via_lead_advect(d))
    field_ok = placed_field_supported(decomp, shape, paxes)
    buffers: dict = {}  # the field apply's halo-extended buffers, one per shape and dtype

    def field_fn(x, g, inv_dx2, surgery, avg):
        if field_ok:
            return placed_diff_field(x, g, inv_dx2, surgery, avg, paxes, buffers)
        return blocks.via_lead(
            lambda v: diff_field(v, blocks.lead_copy(g), inv_dx2, surgery, avg), x)

    def custom_fn(fn, x, params):
        # an opaque operator: one counted gather on the lead device per apply
        return blocks.via_lead(lambda v: fn(v, *params), x)

    return {"stencil_fn": stencil_fn, "advect_fns": advect_fns, "field_fn": field_fn,
            "custom_fn": custom_fn}


def _decomp_fns(decomp, x0, term_descs, paxes=()) -> dict:
    """The block-wise applies of a decomposed solve, as ``_make_Aop``
    keywords: ``stencil_fn`` where the gate holds (5-point axes stay on the
    global kernel) and ``advect_fns`` for the Div/Conv terms whose limiter
    and blocks the advection gate takes; a placed decomposition's
    (``_placed_fns``)."""
    if decomp is None:
        return {}
    shape = tuple(x0.shape[1:])
    if decomp.placed:
        return _placed_fns(decomp, x0, term_descs, paxes)
    fns = {}
    if sharded_supported(decomp, shape):
        blockwise = make_sharded_apply(decomp, len(shape))

        def stencil_fn(coeffs, x):
            if any(len(cs) == 5 for cs in coeffs):
                return axis_stencil(coeffs, x)
            return blockwise(coeffs, x)

        fns["stencil_fn"] = stencil_fn
    fns["advect_fns"] = {
        i: make_sharded_advect_apply(decomp, "div" if d[0] == "div_field" else "conv",
                                     x0.shape[0], d[6], d[4], d[5])
        for i, d in enumerate(term_descs)
        if d[0] in ("div_field", "conv_field") and sharded_advect_supported(decomp, shape, d[6])
    }
    return fns


def _neumann_row_scale_vecs(nx, bcs) -> tuple[list[np.ndarray], bool]:
    """Per-axis row-scale vectors (``nx``: the solve's grid) for the
    Neumann/Symmetry elimination asymmetry (``A[1,2]=2/3`` vs
    ``A[2,1]=1``; 3/2 on the surgered rows). Returns ``(dvs, any_scale)``."""
    dvs = []
    any_scale = False
    for j, n in enumerate(nx):
        dv = np.ones(n)
        for bc in bcs:
            if bc.bc_type in ("neumann", "symmetry") and bc.bc_face_dim == j:
                dv[1 if bc.bc_n_dir < 0 else n - 2] = 1.5
                any_scale = True
        dvs.append(dv)
    return dvs, any_scale


def _null_shift_field(vecs, device, layout=None):
    """Deferred ``(1, *nx)`` row-scale field, composed per call from the
    per-axis vectors (block vectors of ``layout`` when given)."""
    vecs = tuple(device_array(v, device=device)[None] for v in vecs)
    if layout is not None:
        vecs = tuple(blocks.scatter(v, layout) for v in vecs)

    def build():
        ns = None
        for v in vecs:
            ns = v if ns is None else ns * v
        return ns

    return build


def _ids(term_descs, kind: str) -> list[int]:
    return [i for i, d in enumerate(term_descs) if d[0] == kind]


def fd_separable(term_descs, tparams) -> bool:
    """Whether the equation is exactly one constant-coefficient 3-point
    axis term plus any number of ddt terms — the Kronecker sum (shifted by
    ``c_dt I``) the direct solve inverts."""
    ax = _ids(term_descs, "axis")
    return (
        len(ax) == 1
        and all(d[0] in ("axis", "ddt") for d in term_descs)
        and all(len(cs) == 3 for cs in tparams[ax[0]]["axis_np"])
    )


def fd_setup(term_descs, tparams, slicer, paxes=(), for_precond=False, why="fastdiag",
             obstacles=False):
    """The axis terms the fast-diagonalization solve inverts and the one
    whose scalar streams (``linalg.py::_fd_setup``): the DIRECT solve needs
    one 3-point axis term plus ddt terms; the PRECONDITIONER also takes
    other terms and leaves the non-separable ones out, but for a custom
    term's separable ``fd_hint`` (descriptor slot 5), which enters as
    frozen axis matrices. With several axis terms, or any hint, the
    matrices are summed with the current ``sign * param`` weights frozen
    in (``c_ax`` then pins to 1; ``c_dt`` streams). Returns ``(terms,
    i_ax)``, ``terms`` the ``(weight, axis_np)`` pairs whose weighted
    per-axis matrices sum to the inverted operator. Raises ValueError for
    what it cannot take, obstacles among it (``linalg.py:1101-1105``)."""
    if obstacles:
        raise ValueError(f"{why}: obstacles break the product structure of the active set — "
                         "use cg/bicgstab with precond 'mg'")
    ax_ids, ddt_ids = _ids(term_descs, "axis"), _ids(term_descs, "ddt")
    exact_ax = len(ax_ids) == 1 and len(ax_ids) + len(ddt_ids) == len(term_descs)
    hint_ids = ([i for i in _ids(term_descs, "custom") if term_descs[i][5] is not None]
                if for_precond else [])
    ok = ((ax_ids or hint_ids) and (exact_ax or for_precond)
          and all(len(cs) == 3 for i in ax_ids for cs in tparams[i]["axis_np"]))
    if not ok:
        raise ValueError(
            f"{why}: equation must be one 3-point axis term (laplacian) plus ddt terms with "
            "scalar coefficients"
            + (" (precond 'fd' also accepts extra terms, which it leaves out unless they "
               "carry an fd_hint)" if for_precond else "")
        )
    if len(ax_ids) == 1 and not hint_ids:
        return ((1.0, tparams[ax_ids[0]]["axis_np"]),), ax_ids[0]
    return tuple(
        [(term_descs[i][2] * (tparams[i]["param"] if term_descs[i][3] else 1.0),
          tparams[i]["axis_np"]) for i in ax_ids]
        + [(term_descs[i][2], tuple(tuple(np.asarray(c, dtype=np.float64) for c in ax)
                                    for ax in term_descs[i][5])) for i in hint_ids]
    ), None


def fastdiag_factors(terms, slicer, paxes, dtype, device, fd_opts=None) -> FastDiag:
    """Eigen-factors of the summed, weighted per-axis active-set matrices
    of ``terms`` (host ``eigh``, uploaded to ``device``), cached by the
    coefficient vectors, weights, active set, periodic axes, dtype, device
    and ``fd_opts`` (the transforms' precision and the factors' dtype) —
    all they depend on; a new ``dt`` streams through the symbol and
    re-factorizes nothing. Raises ValueError when an axis is not diagonally
    symmetrizable, or on an ``fd_opts`` the port does not take."""
    precision, tdt = fd_options(fd_opts)
    key = (str(dtype), str(device), precision, str(tdt),
           tuple((s.start, s.stop) for s in slicer), tuple(paxes),
           tuple((w, tuple((c.dtype.str, c.tobytes()) for cs in axis_np for c in cs))
                 for w, axis_np in terms))
    if key not in _FD_CACHE:
        mats = None
        for w, axis_np in terms:
            mi = [w * axis_matrix_np(*cs, active=sl, periodic=j in paxes)
                  for j, (cs, sl) in enumerate(zip(axis_np, slicer))]
            mats = mi if mats is None else [a + m for a, m in zip(mats, mi)]
        _FD_CACHE[key] = FastDiag(mats, dtype=dtype, device=device, transform_dtype=tdt,
                                  precision=precision)
        while len(_FD_CACHE) > _FD_CACHE_MAX:
            _FD_CACHE.popitem(last=False)
    _FD_CACHE.move_to_end(key)
    return _FD_CACHE[key]


def _fd_scalars(term_descs, i_ax):
    """``tparams -> (c_ax, c_dt)`` of the eigen-symbol: the streamed axis
    term's ``sign * param`` (1 when the weights are frozen into the
    matrices, ``i_ax`` None) and ``sum sign * inv_dt`` of the ddt terms."""
    ddt = [(term_descs[i][2], i) for i in _ids(term_descs, "ddt")]

    def scalars(tp):
        c_ax = 1.0
        if i_ax is not None:
            c_ax = term_descs[i_ax][2] * (tp[i_ax]["param"] if term_descs[i_ax][3] else 1.0)
        c_dt = 0.0
        for s, i in ddt:
            c_dt = c_dt + s * tp[i]["inv_dt"]
        return c_ax, c_dt

    return scalars


def _make_fd_precond(config, term_descs, tparams, slicer, paxes, x0, pre_scale=None,
                     obstacles=False, lay=None):
    """The FD preconditioner and its per-call scalar hook; ``(None, None)``
    when the equation has no usable separable part and ``fd_fallback`` is
    set (an unpreconditioned solve, as the JAX package). ``lay``: the
    placed layout, whose pencils must divide (``NotImplementedError``)."""
    try:
        terms, i_ax = fd_setup(term_descs, tparams, slicer, paxes, for_precond=True,
                               why="precond 'fd'", obstacles=obstacles)
        fd = fastdiag_factors(terms, slicer, paxes, x0.dtype, x0.device,
                              config.get("fd_opts"))
    except ValueError:
        if config.get("fd_fallback"):
            return None, None
        raise
    if lay is not None:
        fd.place(slicer, lay)  # factors on the blocks' devices; a pencil that cannot divide raises
    p = FDPrecond(fd, (slice(None),) + tuple(slicer), pseudo=config.get("nullspace") == "mean",
                  pre_scale=pre_scale)
    scalars = _fd_scalars(term_descs, i_ax)

    def setup(tp):
        p.set_scalars(*scalars(tp))

    return p, setup


def _axis_fields(vecs, dim: int, dtype):
    """Per-axis vectors as host arrays broadcastable along their axis."""
    ndt = np_dtype(dtype)
    return tuple(
        np.asarray(dv, dtype=ndt).reshape(tuple(-1 if k == j else 1 for k in range(dim)))
        for j, dv in enumerate(vecs)
    )


def make_mg_spec(config, x0, bcs, mesh, term_descs, paxes=(), decomp=None) -> MGSpec:
    """The multigrid spec of ``precond: "mg"`` (``_make_mg_spec`` of the JAX
    package): per-axis face kinds for the level surgery, the Γ-aware
    hierarchy for variable-Γ equations (face rule of the first such term),
    the cycle dtype, the decomposition and the ``mg_opts`` knobs; cached by
    its key."""
    mg_opts = dict(config.get("mg_opts") or {})
    cycle_dtype = mg_opts.pop("dtype", None)
    fk = [["dirichlet", "dirichlet"] for _ in range(mesh.dim)]
    for bc in bcs or []:
        if bc.bc_type in ("neumann", "symmetry"):
            fk[bc.bc_face_dim][0 if bc.bc_n_dir < 0 else 1] = "neumann"
    vg = [d for d in term_descs if d[0] == "diff_field"]
    spec = MGSpec(
        x0.shape[1:],
        [float(l) for l in np.asarray(mesh._lx_np)],
        dtype=x0.dtype,
        cycle_dtype=cycle_dtype,
        paxes=tuple(paxes),
        face_kinds=tuple(tuple(p) for p in fk),
        var_gamma=bool(vg),
        vg_avg=vg[0][5][1] if vg else "arithmetic",
        rz=mesh.coord_sys == "rz",
        r_lower=float(mesh._lower_np[0]),
        decomp=decomp,
        device=x0.device,
        **mg_opts,
    )
    if spec.key not in _MG_CACHE:
        _MG_CACHE[spec.key] = spec
        while len(_MG_CACHE) > _MG_CACHE_MAX:
            _MG_CACHE.popitem(last=False)
    _MG_CACHE.move_to_end(spec.key)
    return _MG_CACHE[spec.key]


def _make_Aop_dot(term_descs, tparams, dim: int):
    """The CG operator fused with its alpha-dot, when the equation is one
    3-point axis term with a scalar coefficient plus any ddt terms on a
    3-D grid (the JAX conditions without its TPU shape gate): ``tparams ->
    (d -> (A d, sum(d * A d)))`` with the term's ``sign * param`` folded
    into the coefficient vectors and the ddt shift ``sum sign * inv_dt``
    into the axis-0 centre vector, once per solve. None otherwise."""
    if not (dim == 3 and fd_separable(term_descs, tparams)):
        return None
    i_ax = _ids(term_descs, "axis")[0]
    sign0, has_p0 = term_descs[i_ax][2:4]
    shift = _fd_scalars(term_descs, None)

    def Aop_dot(tp):
        scale = sign0 * (tp[i_ax]["param"] if has_p0 else 1.0)
        coeffs = [[(c * scale).contiguous() for c in cs] for cs in tp[i_ax]["axis"]]
        c_dt = shift(tp)[1]
        if c_dt:
            coeffs[0][1] = coeffs[0][1] + c_dt
        coeffs = tuple(map(tuple, coeffs))  # frozen: the kernel's launch plan is kept
        return lambda d: axis_stencil_dot(coeffs, d)

    return Aop_dot


def build_solver(config, mesh, x0, grid, term_descs, tparams, bcs, method, criterion,
                 tol, max_it, slicer, paxes=(), decomp=None):
    """Assemble the solve of ``method`` on the (periodic-reduced) grid of
    ``x0``; returns ``fn(x0, rhs, tparams, bc_vals) -> (x, itr, tol,
    hist)``, the row-scale fields ``sym_vecs`` the RHS must be multiplied
    by (None: no scaling) and ``rhs_shift`` (``tparams -> A e``, the
    affine shell shift of nonzero-flux obstacle Neumann BCs that the RHS
    sheds first; None without one). Everything here is host work, redone
    per call, so nothing cached can hold a stale BC, mask or scalar (the
    MG hierarchy is keyed by its structure, the eigen-factors by their
    matrices; the static obstacle masks live on their BC objects).

    Obstacle cells are pinned (Dirichlet) or dependent (Neumann) and leave
    the active set; the Neumann shells' linear part folds into the
    operator applied to search directions (``linalg.py:958-975``)."""
    static, dyn_idxs = [], []
    for i, bc in enumerate(bcs):
        if bc.bc_type in _OBSTACLE:
            if getattr(bc, "dynamic", False):
                dyn_idxs.append(i)
            else:
                static.append(bc)
    obn = tuple(bc for bc in bcs if bc.bc_type == "obstacle_neumann")
    obstacles = bool(static or dyn_idxs)
    lay = (blocks.layout(decomp, x0.shape[1:], x0.device)
           if decomp is not None and decomp.placed else None)
    M = _MaskSpec(tuple(x0.shape[1:]), slicer, x0.dtype, x0.device, static, dyn_idxs, lay)
    apply_bcs = apply_bcs_fn(bcs, grid)
    if lay is not None:
        apply_bcs = blocks.apply_bcs_fn(bcs, grid, lay, apply_bcs)
    Aop = raw_Aop = _make_Aop(term_descs, **_decomp_fns(decomp, x0, term_descs, paxes))
    if obn:
        def Aop(v, tp):
            for bc in obn:
                v = bc.apply_linear(v)
            return raw_Aop(v, tp)
    rhs_shift = None
    affine = tuple(bc for bc in obn if bc.bc_val != 0.0)
    if affine:
        def rhs_shift(tp):
            e = None
            for bc in affine:  # placed: made block by block
                f = bc.affine_field(x0.shape, x0.dtype, x0.device if lay is None else lay)
                e = f if e is None else e + f
            return raw_Aop(e, tp)
    project_mean = config.get("nullspace") == "mean"
    act_sel = (slice(None),) + tuple(slicer)
    dvs, any_scale = _neumann_row_scale_vecs(x0.shape[1:], bcs)
    # only diffusion/transient equations of constant coefficients take the
    # 3/2 row scale: a variable-Γ term's surgered-row asymmetry is
    # Γ-dependent, and advection is nonsymmetric anyway
    any_scale = any_scale and all(d[1] in ("laplacian", "ddt") and d[0] in ("axis", "ddt")
                                  for d in term_descs)

    if method == "fastdiag":
        terms, i_ax = fd_setup(term_descs, tparams, slicer, paxes, obstacles=obstacles)
        fd = fastdiag_factors(terms, slicer, paxes, x0.dtype, x0.device, config.get("fd_opts"))
        if lay is not None:
            fd.place(slicer, lay)  # as in _make_fd_precond
        null_shift = None
        if project_mean and any_scale:
            null_shift = _null_shift_field(_axis_fields(dvs, mesh.dim, x0.dtype), x0.device, lay)
        fn = build_fastdiag(
            Aop, apply_bcs, M, tol, max_it, fd,
            act_sel=act_sel,
            scalars=_fd_scalars(term_descs, i_ax),
            project_mean=project_mean,
            null_shift=null_shift,
        )
        return fn, None, rhs_shift

    # Symmetrization row scaling (CG + Neumann/Symmetry faces): the
    # boundary-node elimination makes the surgered rows nonsymmetric
    # (A[1,2] = 2/3 vs A[2,1] = 1); scaling them by 3/2 per axis (D =
    # kron_j D_j) restores exact symmetry, so CG on D A x = D b is rigorous
    # and matches the symmetrized V-cycle.
    sym_vecs = None
    if method == "cg" and any_scale:
        sym_vecs = tuple(
            device_array(v, device=x0.device)[None]
            for v in _axis_fields(dvs, mesh.dim, x0.dtype)
        )
        obs_Aop = Aop
        # the dispatch scales the global RHS; the operator, the vectors of
        # its input's placement
        row_scale = (sym_vecs if lay is None
                     else tuple(blocks.scatter(d, lay) for d in sym_vecs))

        def Aop(v, tp):
            out = obs_Aop(v, tp)
            for d in row_scale:
                out = out * d
            return out

    precond_kind = config.get("precond")
    mg = precond = precond_setup = None
    if precond_kind in ("fd", "fastdiag"):
        pre_scale = None
        if sym_vecs is not None:
            # the eigen-solve inverts A, so it sees D^-1 r: (D A)^-1 exactly
            # (placed: over the whole blocks, no view)
            pre_scale = 1.0 / _null_shift_field(_axis_fields(dvs, mesh.dim, x0.dtype),
                                                x0.device, lay)()
            if lay is None:
                pre_scale = pre_scale[act_sel]
        precond, precond_setup = _make_fd_precond(config, term_descs, tparams, slicer, paxes, x0,
                                                  pre_scale, obstacles, lay)
    elif precond_kind == "mg":
        # an obstacle system takes the plain-domain V-cycle: the cycle knows
        # nothing of the excluded cells, the Krylov loop masks its output
        mg = make_mg_spec(config, x0, bcs, mesh, term_descs, paxes, decomp)
        precond = mg.preconditioner()
        if mg.var_gamma:
            i_vg = _ids(term_descs, "diff_field")[0]

            def precond_setup(tp):
                # placed: Γ's block vector, sampled down block by block
                mg.set_gamma(tp[i_vg]["gamma"])
    fmg_init = mg.fmg_initializer() if mg is not None and mg.fmg_init else None
    if method == "bicgstab":
        fn = build_bicgstab(Aop, apply_bcs, M, tol, max_it, criterion, precond,
                            fmg_init=fmg_init, precond_setup=precond_setup)
        return fn, None, rhs_shift

    # the fused alpha-dot is off under a decomposition (linalg.py:1040-1049)
    # and with Neumann obstacle shells (the operator carries their fold)
    Aop_dot = (_make_Aop_dot(term_descs, tparams, mesh.dim)
               if sym_vecs is None and decomp is None and not obn else None)
    # fused dot(r, z): only where the interior mask is exactly the MG mask
    # (no obstacle cells, no torus reduction; linalg.py:1315-1320)
    precond_dot = (mg.preconditioner_dot()
                   if mg is not None and mg.can_fuse_rz() and not obstacles and not paxes
                   else None)
    null_shift = None
    if sym_vecs is not None:
        null_shift = _null_shift_field(_axis_fields(dvs, mesh.dim, x0.dtype), x0.device, lay)
    fn = build_cg(
        Aop, apply_bcs, M, tol, max_it, criterion, precond,
        project_mean=project_mean, Aop_dot=Aop_dot, fmg_init=fmg_init,
        precond_dot=precond_dot, null_shift=null_shift, precond_setup=precond_setup,
    )
    return fn, sym_vecs, rhs_shift
