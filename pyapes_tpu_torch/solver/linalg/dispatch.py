"""Linear-solve dispatch (port of ``pyapes_tpu/solver/linalg.py::solve``):
term records -> descriptors and per-call params, the torus reduction of
periodic axes, method resolution, and the report.

Ported: ``method`` ``"fastdiag"``, ``"cg"`` and ``"bicgstab"`` (so the
``fd_fallback`` of a non-separable equation resolves to a working
method), with ``precond`` ``"mg"`` (the multigrid V-cycle, ``mg_opts``),
``"fd"`` (the fast-diagonalization preconditioner) or None / ``"none"``,
with Dirichlet, Neumann, Symmetry and periodic faces (an axis with
both faces periodic is solved on the reduced torus: the duplicate seam
node is dropped, every node is active, the stencil wraps, and the seam is
re-appended after the solve), for the term kinds ``axis`` (constant
coefficients, 3- or 5-point: laplacian, div, grad), ``diff_field``
(variable-Γ Laplacian), ``div_field`` / ``conv_field`` (per-point
advection), ``custom`` (``fdm.custom``: a linear torch function; its
``fd_hint`` feeds ``precond: "fd"``; not on periodic axes) and ``ddt``,
on Cartesian and axisymmetric (rz) grids; with a
domain decomposition (``decomp``: a ``DomainDecomposition``) the axis and
advection terms apply block by block (``build.py``). A placed
decomposition (``devices`` given: each block on its own device) runs
``"fastdiag"``, and CG and BiCGSTAB unpreconditioned or with ``precond``
``"mg"`` (Γ-aware for a variable-Γ term) or ``"fd"``, on block vectors
(``parallel/blocks.py``; the eigen-transforms in pencil layouts, the
blocks moved between them by an all-to-all of peer copies), with every
term kind and option of the whole-tensor path: ``x0``, the RHS, Γ and the
advector are scattered to the blocks at entry (the JAX package's
``_commit_to_decomp``) and the solution is gathered back into the Field
at exit — unless they are block vectors already (``blocks.BlockTensor``,
the counterpart of an array committed to a ``NamedSharding``): a Field
whose value is on blocks is solved on them and keeps the solution there
(the decomposition its own when the config names none; a block vector
on another cut of the grid is moved with ``blocks.repartition``, as JAX
re-shards a committed array; on a periodic axis of ``2^k + 1`` nodes the
Field's blocks are the torus' with the seam plane in the last one, so
the torus reduction is a per-block view and the seam's re-append one
face copy), a block RHS, Γ or advector is taken as it is. An
``fdm.custom`` term (an opaque function) applies through one counted
gather on the lead device per apply; an immersed obstacle's mask is cut
per block (a dynamic body's mask of the call scattered once, counted
with the operands) and a Neumann body's shells read their sources from
the neighbouring blocks that hold them; a BC value resolved per
application (``per_iteration``) reads the iterate through one counted
gather per application; ``debug: "nan"`` checks each block on its own
device; ``donate`` works in the blocks it is given (a block Field's own),
or gathers a whole Field's solution into its ``x0``. A placed ``sync:
False`` solve on the card is one CUDA graph of the solve call (the
entry's scatter and the exit's gather inside it) where every block lies on
the lead card; where the blocks lie on several cards it is one graph per
card (``graph_loop.GraphedCall``'s lanes), each card's loops WHILE nodes
of its own graph that end on its own replica of the loop's exit (the
per-card form, ``graph_loop.per_card``: every scalar replicated, every sum
combined on every card in block order, every move between cards an
``ops.peer`` put and wait), the entry's scatter and the exit's gather
ordinary copies before the launches and after them. Inside a graph the
solve is captured where it stands: on one card into that card's graph;
across cards inside a capture of one graph per card whose lanes are its
cards (``GraphedCall(fn, lead, lanes=blocks.card_lanes(decomp, lead))``,
the graphs of a fused whole step across cards among them), in the per-card
form, its entry's scatter and exit's gather puts and waits in the lanes.
A capture of one graph holding a solve across cards raises, and so do
blocks on the host in any graph (``_check_placed``; a ``sync: False`` solve
with host blocks runs the host loop). Immersed obstacles
(``ObstacleDirichlet``, static or dynamic, and ``ObstacleNeumann``) leave
the active set; under a torus reduction their masks are reduced too, every
call, and a body on the duplicate seam plane raises. The multigrid hierarchy of a periodic axis
lives on the reduced torus too (``MGSpec(paxes=...)``).

The options: ``fd_opts`` (``precision`` "highest" / "default", the
latter TF32 transforms on the card; the factors' ``dtype``), ``kernel``
("auto" / "pallas", one path; "jnp" raises ``NotImplementedError``: no
plain tier on the card), ``debug: "nan"`` (the loop on the host under
``utils.debug``'s NaN check, ``NaNError`` naming the first operation or
hand kernel whose output holds a NaN; a ValueError inside a fused whole
step, as the JAX package) and ``donate`` (the solution in the initial
guess's storage, an eager solve off the torus). What a placed
decomposition does not take (a capture of one graph across cards, a graph
with host blocks) raises ``NotImplementedError`` — never a silent detour to
another path.
"""
from __future__ import annotations

import copy
from collections import OrderedDict
from typing import TypedDict

import numpy as np
import torch

from pyapes_tpu_torch.mesh.tools import boundary_slicer
from pyapes_tpu_torch.parallel import blocks
from pyapes_tpu_torch.parallel.decomp import DomainDecomposition
from pyapes_tpu_torch.solver.fastdiag import _symmetrize_similarity, axis_matrix_np, fd_options
from pyapes_tpu_torch.solver.fdm import ddt_leading_coeff
from pyapes_tpu_torch.solver.linalg.build import (
    _FD_CACHE,
    _MG_CACHE,
    _OBSTACLE,
    build_solver,
    fd_separable,
)
from pyapes_tpu_torch.ops.graph_loop import (
    GraphedCall,
    capturing,
    graph_lanes,
    host_loops,
    in_whole_step,
    keep_alive,
    per_card,
    per_card_mode,
    use_host_loops,
)
from pyapes_tpu_torch.utils import device_cache
from pyapes_tpu_torch.utils.debug import nan_check
from pyapes_tpu_torch.utils.device_cache import device_coeffs, is_constant


entry_scatters = 0
"""Whole ``x0`` / RHS tensors scattered to the blocks at a placed solve's
entry (a counter; a block vector of the solve is taken as it is)."""
exit_gathers = 0
"""Placed solutions gathered back on the lead device into a whole Field at
a solve's exit (a counter; a Field on blocks keeps its solution there).
Both count in Python: a graphed ``sync: False`` solve or a fused step counts
at its warm-up and at its capture, not at a replay."""


class ReportType(TypedDict):
    """Solver report (reference ``linalg.py:22-30``); under ``sync: False``
    ``itr`` and ``tol`` are 0-d device tensors."""

    itr: int
    tol: float
    converge: bool


def clear_cache() -> None:
    """Drop the cached eigen-factors, multigrid hierarchies, solve graphs
    and device constants (a live graph keeps what it reads)."""
    _FD_CACHE.clear()
    _MG_CACHE.clear()
    _GRAPH_CACHE.clear()
    device_cache.clear()


def _term_descriptor(rec) -> tuple:
    """Static description of one equation term: ``(kind, name, sign,
    has_param, surgery, form, limiter)``. ``kind`` "axis" (a per-axis
    coefficient stencil, 3- or 5-point), "diff_field" (variable-Γ
    Laplacian; ``form`` ``(inv_dx2, avg)``), "div_field" / "conv_field"
    (per-point advection; ``form`` "conservative" / "advective"), "custom"
    (``fdm.custom``; ``form`` its ``fd_hint`` or None) or "ddt"; ``surgery``
    the per-axis BC kinds of the per-point terms."""
    name = rec["name"].lower()
    sign = float(rec["sign"])
    o = rec.get("other") or {}
    if name == "ddt":
        return ("ddt", name, sign, False, None, None, None)
    if name == "custom":
        # the separable fd_hint (a nested float tuple) rides the form slot
        return ("custom", name, sign, False, None, o.get("fd_hint"), None)
    if name == "conv":
        return ("conv_field", name, sign, False, o["surgery"], "advective", rec["limiter"])
    if rec.get("adv") is not None:
        return ("div_field", name, sign, False, o["surgery"], o["form"], rec["limiter"])
    if o.get("var_gamma"):
        return ("diff_field", name, sign, False, o["surgery"], (o["inv_dx2"], o["avg"]), None)
    if name not in ("laplacian", "div", "grad") or rec.get("axis_coeffs") is None:
        raise NotImplementedError(f"linalg: {rec['name']} terms are ported in a later slice")
    return ("axis", name, sign, name in ("laplacian", "grad") and rec["param"][0] is not None,
            None, None, None)


def _periodic_axes(bcs, dim: int) -> tuple[int, ...]:
    """Axes whose BOTH faces are periodic."""
    count = [0] * dim
    for bc in bcs or []:
        if bc.bc_type == "periodic":
            count[bc.bc_face_dim] += 1
    return tuple(j for j in range(dim) if count[j] == 2)


def _reduced(dim: int, paxes) -> tuple:
    """Index of the reduced torus on a ``(vdim, *nx)`` array: the duplicate
    seam node of each periodic axis dropped."""
    return (slice(None),) + tuple(slice(None, -1) if j in paxes else slice(None)
                                  for j in range(dim))


def _reduce_vecs(vecs, paxes) -> tuple:
    """Per-axis coefficient vectors on the reduced torus: on a periodic
    axis the duplicate entry goes and the seam surgery is undone (the
    vectors are constant along a periodic axis: filled with the middle
    value; ``linalg.py:441-465``). Host numpy."""
    out = []
    for ax, cs in enumerate(vecs):
        if ax in paxes:
            n = cs[0].shape[0] - 1
            out.append(tuple(np.full((n,), c[n // 2], dtype=c.dtype) for c in cs))
        else:
            out.append(tuple(cs))
    return tuple(out)


def _term_params(rec, desc, x0: torch.Tensor, paxes=()) -> dict:
    """Per-call operands of one term on the solve's device and dtype, on
    the reduced torus of ``paxes``: ``inv_dt`` (ddt: ``1/dt``, ``1.5/dt``
    for an active BDF2); the advecting field and the base vectors
    (div/conv); Γ (diff_field); the function and its params (custom);
    else the coefficient vectors (``axis``),
    their host copies for the factorization (``axis_np``) and the scalar
    coefficient."""
    kind = desc[0]
    red = _reduced(x0.ndim - 1, paxes)
    if kind == "ddt":
        return {"inv_dt": ddt_leading_coeff(rec) / rec["dt"]}
    if kind == "custom":  # the function and its tensors, passed as they are
        return {"fn": rec["other"]["fn"], "cparams": rec.get("custom_params", ())}
    if kind in ("div_field", "conv_field"):
        adv = torch.as_tensor(rec["adv"], dtype=x0.dtype, device=x0.device)[red]
        base = _reduce_vecs(rec["other"]["base"], paxes)
        return {"adv": adv.contiguous(), "base": device_coeffs(base, x0.device, x0.dtype)}
    if kind == "diff_field":
        g = torch.as_tensor(rec["param"][0], dtype=x0.dtype, device=x0.device)
        return {"gamma": g[red[1:] if g.ndim == x0.ndim - 1 else red].contiguous()}
    axis_np = _reduce_vecs(rec["axis_coeffs"], paxes)
    p = {"axis": device_coeffs(axis_np, x0.device, x0.dtype), "axis_np": axis_np}
    if desc[3]:
        p["param"] = float(rec["param"][0])
    return p


def _fd_fallback_method(config, term_descs, tparams, slicer, paxes, mesh, bcs) -> str:
    """Resolve ``method: "fastdiag"`` + ``fd_fallback``: ``"fastdiag"`` when
    the equation is exactly separable (one 3-point axis term plus ddt
    terms; cheap O(n) host probe: every axis diagonally symmetrizable),
    else the configured fallback.

    The JAX package's probe (``linalg.py:694-698``) also rejects any BC
    that carries a ``bc_mask`` — which every domain BC does — so there the
    fallback is always taken; the port tests for obstacles (the mesh's or
    obstacle BCs appended to the field), as intended."""
    fd_ok = (not mesh.obstacle and not any(bc.bc_type in _OBSTACLE for bc in bcs)
             and fd_separable(term_descs, tparams))
    if fd_ok:
        i_ax = next(i for i, d in enumerate(term_descs) if d[0] == "axis")
        try:
            for j in range(mesh.dim):
                _symmetrize_similarity(axis_matrix_np(*tparams[i_ax]["axis_np"][j],
                                                      active=slicer[j], periodic=j in paxes))
        except ValueError:
            fd_ok = False
    return "fastdiag" if fd_ok else str(config["fd_fallback"]).lower()


def _seam_check(mask, paxes, dim: int) -> None:
    """The torus reduction drops the duplicate seam plane; a body
    intersecting it would silently lose solid cells."""
    for j in paxes:
        if mask[tuple(-1 if k == j else slice(None) for k in range(dim))].any():
            raise NotImplementedError(
                f"obstacle touches the periodic seam plane of axis {j}; place bodies off the "
                "duplicate endpoint plane"
            )


def _reduce_obstacles(bcs, paxes, dim: int) -> list:
    """The obstacle BCs on the reduced torus (``linalg.py:551-590``,
    ``:832-866``): per call, copies whose masks lose the seam plane, after
    the seam check — a dynamic body moves between calls, so its current
    mask is the one reduced."""
    red = tuple(slice(None, -1) if j in paxes else slice(None) for j in range(dim))
    out = []
    for bc in bcs:
        if bc.bc_type in _OBSTACLE:
            _seam_check(bc.bc_mask, paxes, dim)
            bc2 = copy.copy(bc)
            bc2.bc_mask = bc.bc_mask[red]
            if bc.bc_type == "obstacle_neumann":
                bc2.faces = [(m[red], ax, sh, fdx) for (m, ax, sh, fdx) in bc.faces]
            bc = bc2
        out.append(bc)
    return out


def _check_decomp(decomp, x0) -> None:
    """A decomposition must be a ``DomainDecomposition`` whose devices exist
    (``check_device``, the placement check), and each cut axis of the
    (torus-reduced) grid must divide into its blocks
    (``linalg.py::_commit_to_decomp``)."""
    if not isinstance(decomp, DomainDecomposition):
        raise TypeError(f"linalg: config 'decomp' must be a DomainDecomposition, got {decomp!r}")
    decomp.check_device(x0.device)
    if len(decomp.mesh_shape) > x0.ndim - 1:
        raise ValueError(f"DomainDecomposition: {len(decomp.mesh_shape)} block axes for a "
                         f"{x0.ndim - 1}-D grid")
    for j, nd in enumerate(decomp.mesh_shape):
        if nd > 1 and x0.shape[1 + j] % nd != 0:
            raise ValueError(
                f"DomainDecomposition: grid axis {j} has {x0.shape[1 + j]} active nodes (after "
                f"periodic de-duplication), not divisible by {nd} devices. Choose node counts "
                "divisible by the device count (periodic axes: 2^k + 1 nodes reduce to 2^k)."
            )


def _cards(lead, decomp) -> set:
    """The cards of a placed solve led from ``lead``: its lead's and its
    blocks' (under the CPU tests' stand-in, ``per_card(blocks_as_cards=
    True)``, every block)."""
    if per_card_mode() == "blocks":
        return {f"block {i}" for i in range(len(decomp.devices))}
    return {d for d in (torch.device(lead), *decomp.devices) if d.type == "cuda"}


def lanes_across(lead, decomp):
    """The lanes of the graphs per card that a solve on the placed
    ``decomp`` led from ``lead`` needs inside a graph
    (``blocks.card_lanes``) where its blocks span more than one card; else
    None (every block on the lead's card, or blocks on the host)."""
    return blocks.card_lanes(decomp, lead) if len(_cards(lead, decomp)) > 1 else None


def _check_placed(x0, decomp) -> bool:
    """Whether a placed solve runs in its per-card form inside a graph
    (``graph_loop.per_card``): inside a ``GraphedCall`` of one graph per card
    whose lanes are its cards (``GraphedCall(fn, lead, lanes=blocks.
    card_lanes(decomp, lead))``, a fused whole step across cards among them),
    in its eager warm-up and in its capture alike. Raises
    ``NotImplementedError`` naming ``ROADMAP.md`` A11f for the graphs a
    placed decomposition does not take: blocks on several cards inside a
    graph of one card (``torch.cuda.graph``, ``GraphedCall`` without lanes
    or with other lanes, a whole step of one graph), since a WHILE body
    holds one card's work; blocks on the host inside any graph, since a host
    block's work cannot join a graph of the card. Outside a graph every
    placement passes (a ``sync: False`` solve across cards captures its own
    graphs, one per card)."""
    within = graph_lanes()
    if within is None and not (capturing(x0.device) or in_whole_step()):
        return False
    if x0.device.type == "cuda" and any(d.type != "cuda" for d in decomp.devices):
        raise NotImplementedError(
            "linalg: a CUDA graph or a fused whole step on a placed decomposition with blocks "
            "on the host is not ported (ROADMAP.md A11f): a host block's work cannot join a "
            "graph of the card; step eagerly (model.run(fused=False))")
    lanes = lanes_across(x0.device, decomp)
    if lanes is None:
        return False
    if within != lanes:
        cards = sorted(map(str, _cards(x0.device, decomp)))
        raise NotImplementedError(
            f"linalg: a solve on a placed decomposition whose blocks lie on more than one card "
            f"({cards}) inside a capture of one graph is not ported (ROADMAP.md A11f): a loop's "
            f"WHILE body holds one card's work. Capture one graph per card instead, "
            f"GraphedCall(fn, {str(x0.device)!r}, lanes=blocks.card_lanes(decomp, "
            f"{str(x0.device)!r})) (the lanes {[str(d) for d in lanes]}); a fused whole step "
            "(model.run(fused=True)) does so itself")
    return True


def _place_operands(tparams, lay) -> tuple:
    """The per-call operands of a placed solve: Γ and the advector scattered
    to the blocks (``blocks.scatter_operand``, once per solve, as the JAX
    package's ``_commit_to_decomp`` shards exactly these two), or taken as
    they are where they are block vectors already (moved where they lie on
    another cut, an isotropic Γ viewed as ``(1, *nx)``); the others as they
    are."""
    out = []
    for tp in tparams:
        tp = dict(tp)
        for k in ("gamma", "adv"):
            if k in tp:
                t = tp[k]
                if isinstance(t, blocks.BlockTensor):
                    tp[k] = blocks.scatter(t[None] if t.dim() == len(lay.grid) else t, lay)
                else:
                    tp[k] = blocks.scatter_operand(t, lay)
        out.append(tp)
    return tuple(out)


def _check_config(config) -> None:
    """Raise on an option the port does not take: ``debug`` other than
    "nan"/None, ``kernel`` "jnp" (``NotImplementedError``) or another value
    than "auto"/"pallas"/None, an unported ``precond`` and an ``fd_opts``
    other than ``precision`` "highest"/"default" and a ``dtype``."""
    debug = config.get("debug")
    if debug not in (None, False, "nan"):
        raise ValueError(f"linalg: config 'debug' must be 'nan' or None, got {debug!r}")
    kernel = config.get("kernel")
    if kernel == "jnp":
        raise NotImplementedError(
            "linalg: kernel 'jnp' (the JAX package's plain-jnp tier) is not ported: the port has "
            "no plain tier on the card, where every operator runs its hand-written kernel; use "
            "'auto' or 'pallas' (the kernels on a CUDA tensor, their plain versions on a CPU one)"
        )
    if kernel not in (None, "auto", "pallas"):
        raise ValueError(f"linalg: config 'kernel' must be 'auto' or 'pallas', got {kernel!r}")
    precond = config.get("precond")
    if precond not in (None, "none", "mg", "fd", "fastdiag"):
        raise NotImplementedError(f"linalg: precond {precond!r} is ported in a later slice")
    fd_options(config.get("fd_opts"))


def solve(var, rhs, eqs: dict, config, mesh) -> ReportType:
    """Solve the captured linear system; the solution is written to ``var``.

    Args:
        var: target ``Field``.
        rhs: right-hand side tensor (BC adjustments already folded in).
        eqs: equation-term records from ``Solver.set_eq``.
        config: ``FDMSolverConfig``.
        mesh: the mesh.
    """
    method = config["method"].lower()
    if method not in ("cg", "bicgstab", "fastdiag"):
        raise RuntimeError(
            f"Linalg: solver supports CG, BICGSTAB and FASTDIAG. {method=} is not supported."
        )
    _check_config(config)
    assert min(mesh.nx) >= 3, "Linalg: minimum grid size is 3 per direction"

    tol = float(config.get("tol", 1e-6))
    max_it = int(config.get("max_it", 1000))

    x0_full = var()
    terms = [eqs[k] for k in sorted(eqs)]
    term_descs = tuple(_term_descriptor(rec) for rec in terms)
    paxes = _periodic_axes(var.bcs, mesh.dim)
    # a Field on blocks is solved on them and keeps the solution there
    on_blocks = isinstance(x0_full, blocks.BlockTensor)
    if on_blocks:
        if config.get("decomp") is None:
            config = {**config, "decomp": x0_full.placement.decomp}
        elif not config["decomp"].placed:
            raise ValueError("linalg: a Field whose value is on blocks solves on a placed "
                             "decomposition (blocks on their own devices), not on views")
    if paxes and any(d[0] == "custom" for d in term_descs):
        raise NotImplementedError(
            "custom operators + periodic axes: the torus reduction cannot transform an opaque "
            "operator; use non-periodic BCs or handle wrap inside the custom fn."
        )
    tparams = tuple(_term_params(rec, d, x0_full, paxes) for rec, d in zip(terms, term_descs))
    red = _reduced(mesh.dim, paxes)
    x0, rhs = (x0_full, rhs) if not paxes else (x0_full[red], rhs[red])
    decomp = config.get("decomp")
    if decomp is not None:
        _check_decomp(decomp, x0)
    bcs = [bc for bc in var.bcs if not (bc.bc_type == "periodic" and bc.bc_face_dim in paxes)]
    if paxes:
        bcs = _reduce_obstacles(bcs, paxes, mesh.dim)
    slicer = list(boundary_slicer(mesh.dim, bcs, mesh.coord_sys))
    for j in paxes:
        slicer[j] = slice(None)  # every torus node is active
    slicer = tuple(slicer)
    grid = mesh.grid
    if paxes:
        # no seam surgery on the torus: the wrap is the periodic stencil
        term_descs = tuple(
            d[:4] + (tuple(("none", "none") if j in paxes else k for j, k in enumerate(d[4])),)
            + d[5:] if d[4] is not None else d
            for d in term_descs
        )
        grid = tuple(g[red[1:]] for g in grid)

    if method == "fastdiag" and config.get("fd_fallback"):
        method = _fd_fallback_method(config, term_descs, tparams, slicer, paxes, mesh, bcs)

    sync = config.get("sync", True) is not False
    debug = config.get("debug") == "nan"
    placed = decomp is not None and decomp.placed
    # inside a graph per card (a lanes capture, a whole step across cards):
    # the per-card form, its moves between cards puts and waits in the lanes
    in_lanes = placed and _check_placed(x0, decomp)
    # a placement with blocks on the host runs its sync: False solve as the
    # host loop (its host blocks' work cannot join a graph; each of their
    # copies from the card waits for it all the same)
    graphed = (not sync and x0.device.type == "cuda" and not capturing(x0.device)
               and not use_host_loops() and not debug
               and not (placed and any(d.type != "cuda" for d in decomp.devices)))
    # blocks on several cards: one graph per card, the entry's scatter and
    # the exit's gather outside them
    across = graphed and placed and len(_cards(x0.device, decomp)) > 1

    fn, sym_vecs, rhs_shift = build_solver(
        config, mesh, x0, grid, term_descs, tparams, bcs, method,
        config.get("criterion", "delta"), tol, max_it, slicer, paxes, decomp,
    )
    # under a capture (a fused step), the graph reads the solve's cached
    # hierarchy and factors through ``fn``: it must not outlive them
    keep_alive(fn, rhs_shift)
    if rhs_shift is not None:  # the affine shells of nonzero-flux obstacles
        rhs = rhs - rhs_shift(tparams)
    if sym_vecs is not None:
        # the operator is row-scaled to symmetric; scale b identically
        for d in sym_vecs:
            rhs = rhs * d

    lay = blocks.layout(decomp, x0.shape[1:], x0.device) if placed else None
    # placed: a dynamic obstacle's mask of this call goes to the blocks by
    # content, no whole mask on the lead device (counted with the operands)
    bc_vals = tuple(bc.stream_blocks(x0, grid, lay)
                    if placed and bc.bc_type == "obstacle_dirichlet"
                    else bc.stream_values(x0, grid, t=var.t) for bc in bcs)
    if placed:
        blocks.operand_scatters += sum(v is not None and bc.bc_type == "obstacle_dirichlet"
                                       for bc, v in zip(bcs, bc_vals))
    # donate: the loop works in the initial guess's storage (an eager solve
    # of a contiguous x0; the torus reduction's x0 is a strided view whose
    # solution is re-assembled, and a graph works in its own buffers)
    donate = bool(config.get("donate")) and not (
        paxes or graphed or capturing(x0.device) or in_whole_step() or not x0.is_contiguous())

    def run_cards(xb, rb, tparams_b, bc_vals):
        # the per-card form (replicated scalars, sums on every card, moves
        # between cards through ops.peer) of the built loop, on blocks
        with per_card():
            return fn(xb, rb, tparams_b, bc_vals, donate=False)

    def run(x0, rhs, tparams, bc_vals):
        if placed:
            # x0 and the RHS committed to the blocks (taken as they are where
            # they are block vectors of the solve, moved from another cut),
            # the solution gathered back on the lead device unless the
            # Field's value is on blocks (neither counts among blocks.gathers)
            global entry_scatters, exit_gathers
            entry_scatters += sum(not isinstance(t, blocks.BlockTensor) for t in (x0, rhs))
            exit_gathers += not on_blocks
            # donate: the loop works in the blocks it is given (a block
            # Field's own parts), and a whole Field's exit gather writes
            # into x0's storage
            xb, itr, tol_dev, hist = fn(blocks.scatter(x0, lay), blocks.scatter(rhs, lay),
                                        _place_operands(tparams, lay), bc_vals, donate=donate)
            x = xb if on_blocks else blocks.gather(xb, count=False,
                                                   out=x0 if donate else None)
        else:
            x, itr, tol_dev, hist = fn(x0, rhs, tparams, bc_vals, donate=donate)
        for j in paxes:  # re-append the duplicate seam node (a face copy on blocks)
            x = blocks.append_seam(x, 1 + j)
        return x, itr, tol_dev, hist

    if debug:
        if capturing(x0.device) or in_whole_step():
            # as the JAX package: checkify's check cannot be staged into the
            # fused step's program (FusedStepRunner's capture raises)
            raise ValueError("linalg: debug 'nan' cannot run inside a fused whole step; step "
                             "eagerly (model.run(fused=False)) to check the solves")
        # the loop on the host, every operation and hand kernel checked
        with host_loops(), nan_check():
            x_final, itr, tol_final, hist = run(x0, rhs, tparams, bc_vals)
    elif across:
        # across cards: the entry's scatter, one graph per card (captured
        # at the first call of its key), the exit's gather
        global entry_scatters, exit_gathers
        entry_scatters += sum(not isinstance(t, blocks.BlockTensor) for t in (x0, rhs))
        exit_gathers += not on_blocks
        with per_card():
            lanes = blocks.cards(lay).devices
        xb, itr, tol_final, hist = _graphed_solve(
            run_cards, (config, mesh, method, term_descs, bcs, paxes),
            (blocks.scatter(x0, lay), blocks.scatter(rhs, lay), _place_operands(tparams, lay),
             bc_vals), lanes)
        x_final = xb if on_blocks else blocks.gather(xb, count=False)
        for j in paxes:  # re-append the duplicate seam node (a face copy on blocks)
            x_final = blocks.append_seam(x_final, 1 + j)
    elif graphed:
        # a sync: False solve outside a captured step: one graph of the
        # whole solve call, captured at the first call of its key
        x_final, itr, tol_final, hist = _graphed_solve(
            run, (config, mesh, method, term_descs, bcs, paxes), (x0, rhs, tparams, bc_vals))
    elif in_lanes:
        with per_card():
            x_final, itr, tol_final, hist = run(x0, rhs, tparams, bc_vals)
    else:
        x_final, itr, tol_final, hist = run(x0, rhs, tparams, bc_vals)
    # per card, the report's scalars are the lead card's replicas
    itr, tol_final, hist = (blocks.lead_replica(t) for t in (itr, tol_final, hist))

    if not sync:
        # no host read: itr / tol stay device scalars (NaN detection is
        # deferred to whoever fetches them), the history a device buffer
        var.VAR = x_final
        out_async: ReportType = {"itr": itr, "tol": tol_final, "converge": True}
        if config.get("history"):
            out_async["history"] = hist
        return out_async

    itr_h, tol_h = torch.stack([itr.to(torch.float64), tol_final]).tolist()  # one read
    itr, tol_final = int(itr_h), float(tol_h)
    if np.isnan(tol_final) or np.isinf(tol_final):
        raise RuntimeError(f"Invalid tolerance detected! tol: {tol_final}")
    var.VAR = x_final

    # Krylov: converged means the loop stopped before max_it (the JAX
    # rule); fastdiag's stall exit can stop before max_it at the dtype's
    # accuracy floor, so there converged means the tolerance was MET
    converge = tol_final <= tol if method == "fastdiag" else itr < max_it
    out: ReportType = {"itr": itr, "tol": tol_final, "converge": converge}
    if config.get("report", False):
        print(f"\n{method.upper()}: The solution converged after {itr} iteration.")
        print(f"\ttolerance: {tol_final}")
    if config.get("history"):
        out["history"] = hist[:itr].cpu().numpy()
    return out


# Graphs of whole sync: False solves, by key (the solve's structure, host
# scalars and constants; ``_graph_key``). Bounded LRU.
_GRAPH_CACHE: OrderedDict = OrderedDict()
_GRAPH_CACHE_MAX = 16


class _Slot(int):
    """Position of a per-call tensor among a graphed solve's inputs."""


def _split(tree, tensors: list):
    """``tree`` with every tensor that is not a cached device constant
    replaced by its ``_Slot`` in ``tensors`` (appended)."""
    if isinstance(tree, torch.Tensor):
        if is_constant(tree):
            return tree
        tensors.append(tree)
        return _Slot(len(tensors) - 1)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_split(v, tensors) for v in tree)
    if isinstance(tree, dict):
        return {k: _split(v, tensors) for k, v in tree.items()}
    return tree


def _fill(tree, tensors):
    if isinstance(tree, _Slot):
        return tensors[tree]
    if isinstance(tree, (tuple, list)):
        return type(tree)(_fill(v, tensors) for v in tree)
    if isinstance(tree, dict):
        return {k: _fill(v, tensors) for k, v in tree.items()}
    return tree


def _signature(tree, tensors, refs: list):
    """A hashable description of ``tree`` (from ``_split``): slots by shape
    and dtype (a block vector's also by its layout: one slot, which the
    graph's static copy and its ``copy_`` take block by block), constants
    and objects by identity (kept alive in ``refs``, so no identity is
    reused while the key lives), arrays by content."""
    if isinstance(tree, _Slot):
        t = tensors[tree]
        if isinstance(t, blocks.BlockTensor):
            refs.append(t.placement)
            return ("slot", tuple(t.shape), str(t.dtype), "blocks", id(t.placement))
        return ("slot", tuple(t.shape), str(t.dtype))
    if isinstance(tree, (tuple, list)):
        return tuple(_signature(v, tensors, refs) for v in tree)
    if isinstance(tree, dict):
        return tuple((k, _signature(tree[k], tensors, refs)) for k in sorted(tree))
    if isinstance(tree, np.ndarray):
        return ("array", tree.dtype.str, tree.shape, tree.tobytes())
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    refs.append(tree)
    return ("obj", id(tree))


def _graph_key(static, template, tensors, refs, lanes=None):
    config, mesh, method, term_descs, bcs, paxes = static
    cfg = tuple((k, _signature(config[k], tensors, refs)) for k in sorted(config))
    return (cfg, _signature(mesh, tensors, refs), method,
            _signature(term_descs, tensors, refs), _signature(tuple(bcs), tensors, refs),
            tuple(paxes), _signature(template, tensors, refs),
            tuple(map(str, lanes)) if lanes else None)


def _graphed_solve(run, static, args, lanes=None):
    """``run(*args)`` through the graph of its key (``lanes``: the cards of
    one graph per card, ``GraphedCall``): the first call warms and captures
    it (and returns the eager result), later calls copy the per-call
    tensors in and replay. Outputs are cloned (of a replicated scalar, the
    lead card's replica): the next replay overwrites the graph's own."""
    tensors: list = []
    template = _split(args, tensors)
    refs: list = []
    key = _graph_key(static, template, tensors, refs, lanes)
    if key not in _GRAPH_CACHE:
        _GRAPH_CACHE[key] = (GraphedCall(lambda *ts: run(*_fill(template, ts)), tensors[0].device,
                                         lanes=lanes), refs)
        while len(_GRAPH_CACHE) > _GRAPH_CACHE_MAX:
            _GRAPH_CACHE.popitem(last=False)
    _GRAPH_CACHE.move_to_end(key)
    out = _GRAPH_CACHE[key][0](*tensors)
    return tuple(blocks.lead_replica(o).clone() for o in out)
