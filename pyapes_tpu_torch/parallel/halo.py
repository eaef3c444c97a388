"""Halo exchange and the block-wise applies of a domain decomposition
(PyTorch port of ``pyapes_tpu/parallel/halo.py``).

Each block of ``DomainDecomposition.blocks`` owns a contiguous part of the
grid; the +-1 neighbours a block's face rows need come from its ring
neighbours along each cut axis (``halo_exchange``; the ring wraps, and
the solver masks the rows of a non-periodic global face, as in the JAX
package). All blocks live on the solve's device, so the exchange is a
device copy. It stays its own step: the kernels read a block and its
received ghosts, never the neighbour block.

* ``make_sharded_stencil`` — the plain reference of the block-wise apply
  (ghost rows spliced in with ``torch.cat``), used by the tests.
* ``make_sharded_apply`` — the solver's block-wise apply (the
  counterpart of ``make_sharded_pallas_apply``). 3-D: "extended mode" for
  every block: the block and its ghost faces are copied into one
  halo-extended buffer per shape and dtype, kept by the apply
  (``exchange``), and ``ops.axis_stencil_ext`` writes the block's output
  straight into its view of the global result; one launch per block and
  no patch pass. (The JAX package prefers "overlap
  mode" and reaches its extended kernel only where the TPU's tiling
  rejects a block; on the card every block shape fits, so that rule
  would never run the kernel, and in one process there is no
  communication to overlap.) 2-D: overlap mode, as the JAX package: the
  torus kernel ``ops.axis_stencil`` on the block, then the face rows
  patched with ``coeff * (ghost - wrap)`` (``_patch_face_rows``).
* ``make_sharded_advect_apply`` — the per-point Div/Conv (``advect_pair``
  / ``conv_component`` kernels on each block with no surgery on cut axes,
  then the O(surface) ghost patches and the Neumann/periodic surgery at
  global rows 1 / -2 on the edge blocks, in the JAX package's order). The
  view-based variable-Γ terms run on the whole tensor (GSPMD's choice for
  the JAX package's jnp apply).

On a placed decomposition (``devices`` given) the vector is a
``blocks.BlockTensor`` and the applies work on its blocks, each on its own
device; a block takes only the ghost faces of its ring neighbours
(``exchange_bytes`` counts the bytes moved between blocks, the
counterpart of ``ppermute``'s traffic):

* the axis stencil (``make_sharded_apply``, ``placed_supported``): a
  block keeps its halo-extended buffer on its device (``exchange_block``).
  3-D: one ``axis_stencil_ext`` launch per block into the block's own
  output, with the cut axes among the first two extended; a cut last axis
  wraps inside the block and is patched (``_patch_face_rows``). 2-D: the
  torus ``axis_stencil`` per block and the patch, as above.
* Div and Conv (``make_sharded_advect_apply``, ``_advect_placed``): the
  view-based design per block on its device, ``x``'s ghost faces taken
  from the neighbour blocks; the advector's neighbour faces (read by the
  conservative central Div) are copied once per solve
  (``_operand_faces``).
* the variable-Γ apply and the Γ-aware level pass (``placed_diff_field``,
  ``placed_diff_jacobi``, ``placed_field_supported``): the kernels run on a
  halo-extended buffer of the block (``field_sides``: one ghost row of
  ``x`` on each side that faces another block, and on both global faces
  of a periodic axis) and the interior of their output is kept, a view.
  Γ's halo-extended blocks are built once per solve
  (``_gamma_blocks``). Running the kernel on the extended block, rather
  than on the block with its face rows patched after, is what keeps the
  pass whole: the Jacobi diagonal of a face row depends on the Γ across
  the cut, so a patch would redo the whole row update. A global face
  takes no ghost row, so the kernels' Neumann surgery (rows 1 / -2) and
  end-row mask (rows 0 / -1) land on the global rows of the edge blocks,
  where the surgery is passed; the other sides take "none".
* the multigrid transfers between placed levels (``line_rows``): a block
  reads its own rows and the ghost rows of its line's neighbours that the
  transfer's band reaches (``transfer_ghost_bytes``).
"""
from __future__ import annotations

from math import prod

import torch

from pyapes_tpu_torch.ops.advect import advect_pair, conv_component
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil, axis_stencil_ext
from pyapes_tpu_torch.ops.diff_field import diff_field, diff_jacobi
from pyapes_tpu_torch.parallel.blocks import BlockTensor, copy_into, transfer
from pyapes_tpu_torch.utils.device_cache import block_coeffs, per_solve

exchange_bytes = 0
"""Bytes of ghost faces copied from one block to another by the placed
applies (a counter, like the kernels' ``launches``; like every counter of
this module, a copy captured into a CUDA graph counts at the warm-up and
at the capture, not at a replay)."""
exchange_bytes_across = 0
"""The part of ``exchange_bytes`` copied between blocks on two devices."""
placed_applies = 0
"""Placed applies run (each launches one kernel per block)."""
transfer_ghost_bytes = 0
"""Bytes of the rows a block-wise multigrid transfer (``line_rows``) read
from the other blocks of its line along a cut axis."""


def halo_exchange(x: torch.Tensor, sl, axis: int) -> tuple:
    """``(lo_ghost, hi_ghost)`` of the block at ``sl`` (its index ranges
    per grid axis) along grid ``axis`` of ``x`` ``(vdim, *nx)``: the lower
    ring neighbour's last row and the upper one's first row, over the
    block's extent on the other axes (views of ``x``; the ring wraps, so
    the first block's lower ghost is the last block's last row)."""
    n = x.shape[1 + axis]
    idx = [slice(None), *sl]
    lo = (sl[axis].start - 1) % n
    hi = sl[axis].stop % n
    idx[1 + axis] = slice(lo, lo + 1)
    lo_ghost = x[tuple(idx)]
    idx[1 + axis] = slice(hi, hi + 1)
    return lo_ghost, x[tuple(idx)]


def _shifted(x, ghost_lo, ghost_hi, axis: int):
    """Block-local ``roll(x, +1)`` / ``roll(x, -1)`` along ``axis`` with the
    ghosts in place of the wrap."""
    n = x.shape[axis]
    xm = torch.cat([ghost_lo, x.narrow(axis, 0, n - 1)], dim=axis)  # x[i-1]
    xp = torch.cat([x.narrow(axis, 1, n - 1), ghost_hi], dim=axis)  # x[i+1]
    return xm, xp


def _cut(decomp) -> tuple:
    return tuple(m > 1 for m in decomp.mesh_shape)


def _block_coeffs(coeffs, sl) -> tuple:
    """Per-axis vectors cut to a block (1-D slices stay contiguous)."""
    return tuple(tuple(c[s] for c in cs) for cs, s in zip(coeffs, sl))


def make_sharded_stencil(decomp, coeffs, vdim_ndim: int):
    """Plain reference of the block-wise axis stencil: ``apply(x) -> out``
    equal to ``ops.stencil.apply_axis_stencil`` (in ``x``'s dtype), built
    block by block with ``halo_exchange`` ghosts on cut axes and the torus
    roll on the others.

    Args:
        decomp: ``DomainDecomposition``.
        coeffs: per-axis global ``(ap, ac, am)`` vectors.
        vdim_ndim: rank of the data ``(vdim, *nx)``.
    """
    cut = _cut(decomp)

    def apply(x):
        out = torch.empty_like(x)
        for _, sl in decomp.blocks(x.shape[1:]):
            xb = x[(slice(None), *sl)]
            acc = torch.zeros_like(xb)
            for j, (ap, ac, am) in enumerate(_block_coeffs(coeffs, sl)):
                axis = 1 + j
                shape = [1] * vdim_ndim
                shape[axis] = -1
                if cut[j]:
                    xm, xp = _shifted(xb, *halo_exchange(x, sl, j), axis)
                else:
                    xm, xp = torch.roll(xb, 1, axis), torch.roll(xb, -1, axis)
                acc = acc + ap.reshape(shape) * xp + ac.reshape(shape) * xb \
                    + am.reshape(shape) * xm
            out[(slice(None), *sl)] = acc
        return out

    return apply


def sharded_supported(decomp, global_shape) -> bool:
    """Whether ``make_sharded_apply`` runs this decomposition (the rules
    of ``sharded_pallas_supported``, without its TPU tiling and VMEM
    clauses): a 2-D or 3-D grid with one block axis per grid axis, the
    last (contiguous) axis uncut, every axis divisible into its blocks, at
    least 2 nodes per block on a cut axis — and, in 2-D, at least 3 nodes
    per block on every axis (the torus kernel's minimum)."""
    nd = len(global_shape)
    ms = decomp.mesh_shape
    if nd not in (2, 3) or len(ms) != nd:
        return False
    if ms[-1] != 1:
        return False  # ghost rows of the contiguous axis would be strided
    if any(s % m for s, m in zip(global_shape, ms)):
        return False
    local = tuple(s // m for s, m in zip(global_shape, ms))
    if any(n < 2 for n, m in zip(local, ms) if m > 1):
        return False  # the face patches need distinct first and last rows
    return nd == 3 or min(local) >= 3


def _patch_face_rows(out, x, cs, ghosts) -> None:
    """Replace the wrapped face-row neighbour terms of a torus apply on the
    block ``x`` (``out``, edited in place) with the true ghosts: ``am[0] *
    (lo - wrap_lo)`` on the first row, ``ap[-1] * (hi - wrap_hi)`` on the
    last, per cut axis in ``ghosts`` = ``[(axis, lo, hi), ...]``."""
    for j, lo, hi in ghosts:
        ax = 1 + j
        n = x.shape[ax]
        ap, _ac, am = cs[j]
        out.narrow(ax, 0, 1).add_(am[0] * (lo - x.narrow(ax, n - 1, 1)))
        out.narrow(ax, n - 1, 1).add_(ap[-1] * (hi - x.narrow(ax, 0, 1)))


def exchange(x: torch.Tensor, sl, ext, buffers: dict) -> torch.Tensor:
    """The communication step of extended mode: copy the block at ``sl``
    and, per axis with ``ext[j] == 1``, its two ghost faces
    (``halo_exchange``) into the halo-extended buffer of its shape and
    dtype in ``buffers`` (made at first use, then reused: blocks run in
    stream order); returns the buffer ``(vdim, n_0 + 2 ext_0, ...)``."""
    shape = (x.shape[0],) + tuple(s.stop - s.start + 2 * e for s, e in zip(sl, ext))
    key = (shape, x.dtype, x.device)
    if key not in buffers:
        # zeros: the ghost corners are never read, but stay defined
        buffers[key] = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf = buffers[key]
    inner = [slice(None)] + [slice(e, e + s.stop - s.start) for s, e in zip(sl, ext)]
    buf[tuple(inner)] = x[(slice(None), *sl)]
    for j, e in enumerate(ext):
        if e:
            lo, hi = halo_exchange(x, sl, j)
            buf[tuple(inner[:1 + j] + [slice(0, 1)] + inner[2 + j:])] = lo
            buf[tuple(inner[:1 + j] + [slice(shape[1 + j] - 1, None)] + inner[2 + j:])] = hi
    return buf


def make_sharded_apply(decomp, ndim_mesh: int):
    """The block-wise axis stencil of the solver: ``apply(coeffs, x) -> A
    x`` on the global ``x`` ``(vdim, *nx)`` (port of
    ``make_sharded_pallas_apply``; ``sharded_supported`` must hold). 3-D:
    per block, ``exchange`` then one ``axis_stencil_ext`` launch writing
    into the block's view of the result. 2-D: per block, the torus kernel
    on the block and the face-row patch. Surgery rows of the global
    coefficient vectors land on the edge blocks with the vectors' slices;
    the wrapped ghosts of a non-periodic global face give rows the
    solver's mask discards, as the single-device torus kernel does."""
    ext = tuple(int(c) for c in _cut(decomp))
    buffers: dict = {}  # the apply's halo-extended buffers, one per shape and dtype

    def apply(coeffs, x):
        if isinstance(x, BlockTensor):
            return _apply_placed(coeffs, x, ndim_mesh, buffers)
        out = torch.empty_like(x)
        for _, sl in decomp.blocks(x.shape[1:]):
            cs = _block_coeffs(coeffs, sl)
            if ndim_mesh == 3:
                axis_stencil_ext(cs, exchange(x, sl, ext, buffers), ext,
                                 out=out[(slice(None), *sl)])
                continue
            xb = x[(slice(None), *sl)].contiguous()
            ob = axis_stencil(cs, xb)
            _patch_face_rows(ob, xb, cs, [(j, *halo_exchange(x, sl, j))
                                          for j in range(ndim_mesh) if ext[j]])
            out[(slice(None), *sl)] = ob
        return out

    return apply


# -- placed decompositions: blocks on their own devices ------------------------


def placed_supported(decomp, global_shape) -> bool:
    """Whether the placed apply runs this decomposition: a 2-D or 3-D grid,
    every axis divisible into its blocks, at least 2 nodes per block on a
    cut axis (distinct first and last rows for the patch) and, in 2-D, at
    least 3 on every axis (the torus kernel's minimum). A cut last axis is
    taken (its ghost faces are strided columns): the blocks hold their own
    memory, so nothing constrains the cut as the JAX package's TPU tiling
    does."""
    nd = len(global_shape)
    ms = tuple(decomp.mesh_shape) + (1,) * (nd - len(decomp.mesh_shape))
    if nd not in (2, 3) or len(ms) != nd or any(s % m for s, m in zip(global_shape, ms)):
        return False
    local = tuple(s // m for s, m in zip(global_shape, ms))
    if any(n < 2 for n, m in zip(local, ms) if m > 1):
        return False
    return nd == 3 or min(local) >= 3


def _ghost_faces(x: BlockTensor, b: int, j: int) -> tuple:
    """``(lo, hi)`` ghost faces of block ``b`` along grid axis ``j``: the
    lower ring neighbour's last row and the upper one's first row (views
    on the neighbours' devices)."""
    lay = x.placement
    lo = x.parts[lay.neighbour(b, j, -1)]
    hi = x.parts[lay.neighbour(b, j, 1)]
    return lo.narrow(1 + j, lo.shape[1 + j] - 1, 1), hi.narrow(1 + j, 0, 1)


def line_rows(x: BlockTensor, b: int, j: int, ranges) -> torch.Tensor:
    """The rows of the ``(lo, hi)`` runs ``ranges`` (global indices along grid
    axis ``j``, in the order given, taken modulo the axis' length) of the
    line of blocks along ``j`` through block ``b``, on block ``b``'s device:
    each run cut from the blocks that hold it (a view of block ``b``'s own
    rows; the others' ghost rows copied, counted in
    ``transfer_ghost_bytes``), the pieces concatenated along the axis. The
    rows a block-wise multigrid transfer reads along a cut axis: its own
    and, at the edges of its band, its neighbours'."""
    global transfer_ghost_bytes
    lay = x.placement
    n = lay.grid[j]
    size, cj, dev = n // lay.ms[j], lay.blocks[b][0][j], lay.blocks[b][2]
    pieces = []
    for lo, hi in ranges:
        r = lo
        while r < hi:
            rm = r % n
            c = rm // size
            cnt = min(hi - r, (c + 1) * size - rm)
            k = lay.neighbour(b, j, c - cj)
            piece = x.parts[k].narrow(1 + j, rm - c * size, cnt)
            if k != b:
                transfer_ghost_bytes += piece.numel() * piece.element_size()
                piece = transfer(piece, dev)
            pieces.append(piece)
            r += cnt
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1 + j)


def placed_diff_diag(g: BlockTensor, inv_dx2, surgery, avg: str, wrap=()) -> BlockTensor:
    """The variable-Γ operator's per-point diagonal (``ops.stencil.diff_diag``)
    of the Γ block vector ``g``, block by block on each block's device from
    its halo-extended Γ (``field_sides``; surgery on the sides that lie on
    a global face), the interior kept: no whole-level tensor is made."""
    from pyapes_tpu_torch.ops.stencil import diff_diag

    lay = g.placement
    gext = _gamma_blocks(g, wrap)
    outs = []
    for b, (coord, _, _) in enumerate(lay.blocks):
        sides = field_sides(lay, b, wrap)
        de = diff_diag(gext[b], inv_dx2, _block_surgery(surgery, lay, coord), avg)
        outs.append(de[_interior(sides, g.parts[b].shape)].contiguous())
    return BlockTensor(outs, lay, (1, *lay.grid))


def _count(dev, *faces) -> None:
    """Count ``faces`` copied to a block on ``dev`` (``exchange_bytes``; those
    from another device also in ``exchange_bytes_across``)."""
    global exchange_bytes, exchange_bytes_across
    for f in faces:
        n = f.numel() * f.element_size()
        exchange_bytes += n
        if f.device != torch.device(dev):
            exchange_bytes_across += n


def exchange_block(x: BlockTensor, b: int, ext, buffers: dict) -> torch.Tensor:
    """The placed counterpart of ``exchange``: block ``b`` of the block
    vector ``x`` copied into the halo-extended buffer of its shape, dtype
    and device in ``buffers`` (on the block's device; made at first use),
    and per axis with ``ext[j] == 1`` the two ghost faces of its ring
    neighbours copied in from their devices (``exchange_bytes``); returns
    the buffer."""
    xb = x.parts[b]
    shape = (xb.shape[0],) + tuple(n + 2 * e for n, e in zip(xb.shape[1:], ext))
    key = (shape, xb.dtype, xb.device)
    if key not in buffers:
        buffers[key] = torch.zeros(shape, dtype=xb.dtype, device=xb.device)
    buf = buffers[key]
    inner = [slice(None)] + [slice(e, e + n) for n, e in zip(xb.shape[1:], ext)]
    buf[tuple(inner)] = xb
    for j, e in enumerate(ext):
        if e:
            lo, hi = _ghost_faces(x, b, j)
            copy_into(buf[tuple(inner[:1 + j] + [slice(0, 1)] + inner[2 + j:])], lo)
            copy_into(buf[tuple(inner[:1 + j] + [slice(shape[1 + j] - 1, None)] + inner[2 + j:])],
                      hi)
            _count(xb.device, lo, hi)
    return buf


def _apply_placed(coeffs, x: BlockTensor, ndim_mesh: int, buffers: dict) -> BlockTensor:
    """``A x`` of a block vector, block by block on each block's device,
    into the blocks' own outputs (see the module docstring); the
    coefficient vectors cut to each block and on its device come from
    ``device_cache.block_coeffs``."""
    global placed_applies
    lay = x.placement
    per_block = block_coeffs(coeffs, lay)
    cut = lay.cut
    outs = []
    for b, (_, _, dev) in enumerate(lay.blocks):
        cs, xb = per_block[b], x.parts[b]
        if ndim_mesh == 3:
            ext = (int(cut[0]), int(cut[1]), 0)
            ob = axis_stencil_ext(cs, exchange_block(x, b, ext, buffers), ext)
            patch = [2] if cut[2] else []
        else:
            ob = axis_stencil(cs, xb)
            patch = [j for j in range(2) if cut[j]]
        ghosts = []
        for j in patch:
            lo, hi = _ghost_faces(x, b, j)
            _count(dev, lo, hi)
            ghosts.append((j, transfer(lo, dev), transfer(hi, dev)))
        _patch_face_rows(ob, xb, cs, ghosts)
        outs.append(ob)
    placed_applies += 1
    return BlockTensor(outs, lay, x.shape)


# -- block-wise per-point advection (Div / Conv) -----------------------------


def sharded_advect_supported(decomp, global_shape, limiter: str) -> bool:
    """Whether ``make_sharded_advect_apply`` runs this decomposition (the
    JAX package's ``sharded_advect_supported``): a 2-D or 3-D grid with one
    block axis per grid axis, a central or upwind limiter (QUICK's +-2
    reach needs two ghost rows and stays on the global kernel), the last
    axis uncut, divisible blocks, and at least 3 nodes per block on a cut
    axis (the global surgery rows 1 / -2 sit inside the edge blocks)."""
    nd = len(global_shape)
    ms = decomp.mesh_shape
    if nd not in (2, 3) or len(ms) != nd or limiter not in ("none", "upwind"):
        return False
    if ms[-1] != 1 or any(s % m for s, m in zip(global_shape, ms)):
        return False
    return all(s // m >= 3 for s, m in zip(global_shape, ms) if m > 1)


def _row(a, axis: int, idx: int):
    """Row ``idx`` (negative counts from the end) of ``a`` along ``axis``,
    kept as a length-1 axis."""
    return a.narrow(axis, idx % a.shape[axis], 1)


def make_sharded_advect_apply(decomp, kind: str, vdim: int, limiter: str, surgery, form: str):
    """Block-wise per-point advection (port of
    ``make_sharded_advect_apply``): ``apply(x, adv, base) -> out`` on the
    global arrays (``sharded_advect_supported`` must hold), or on a block
    vector ``x`` of a placed decomposition with ``adv`` a block vector of
    the same placement (``_advect_placed``).

    Per block: the bulk through the ``advect_pair`` (``kind`` "div") or
    ``conv_component`` ("conv") kernel on the block with torus-wrap
    neighbours and no surgery on cut axes; then per cut axis and coupled
    component, the face rows exchange the wrapped neighbour term for the
    ghost's (``coeff * (ghost - wrap)``; in conservative-central form the
    neighbour's advection is part of the coefficient, so the advecting
    field's ghosts are read too), and the edge blocks add the Neumann /
    periodic boundary-node elimination at global rows 1 / -2 with the
    runtime coefficient — in the JAX package's order.

    Args:
        kind: "div" (scalar output) or "conv" (per component).
        vdim: target component count.
        limiter: "none" | "upwind".
        surgery: global per-axis ``(lower, upper)`` kinds.
        form: "conservative" | "advective" (div only).
    """
    assert kind in ("div", "conv")
    nd = len(decomp.mesh_shape)
    ms = decomp.mesh_shape
    cut = _cut(decomp)
    surgery_local = tuple(("none", "none") if cut[j] else tuple(surgery[j]) for j in range(nd))
    conservative = kind == "div" and limiter == "none" and form == "conservative"
    if kind == "conv":
        def pairs(j, ncomp):  # (target, advecting, output) component
            return [(i, j, i) for i in range(vdim)]
    elif vdim > 1:
        def pairs(j, ncomp):
            return [(j, j if ncomp > 1 else 0, 0)]
    else:
        def pairs(j, ncomp):
            return [(0, 0, 0)]

    def block_fixes(o, xb, ab, bs, coord, j, ghosts_x, ghosts_a):
        """The face-row patches and the edge blocks' surgery of axis ``j`` on
        the block output ``o``; ``ghosts_x`` / ``ghosts_a``: the ``(lo,
        hi)`` ghost faces of the target and (conservative central) of the
        advector, on the block's device."""
        apb, _acb, amb = bs[j]
        inv2dx = apb.abs()
        lo_x, hi_x = ghosts_x
        lo_a, hi_a = ghosts_a if conservative else (None, None)
        n = xb.shape[1 + j]
        for ci, ai, oc in pairs(j, ab.shape[0]):
            xi, av = xb[ci], ab[ai]

            def eff_am(row):
                """Coefficient coupling x_{row-1} at ``row``."""
                a_c = _row(av, j, row)
                if limiter == "upwind":
                    return -2.0 * inv2dx[row] * torch.clamp(a_c, min=0.0)
                if conservative:
                    return amb[row] * _row(av, j, row - 1)
                return amb[row] * a_c

            def eff_ap(row):
                """Coefficient coupling x_{row+1} at ``row``."""
                a_c = _row(av, j, row)
                if limiter == "upwind":
                    return 2.0 * inv2dx[row] * torch.clamp(a_c, max=0.0)
                if conservative:
                    return apb[row] * _row(av, j, (row + 1) % n)
                return apb[row] * a_c

            def add_row(row, delta):
                _row(o[oc], j, row).add_(delta)

            # ghost patches at the block faces
            if conservative:
                d_lo = amb[0] * (lo_a[ai] * lo_x[ci] - _row(av, j, -1) * _row(xi, j, -1))
                d_hi = apb[n - 1] * (hi_a[ai] * hi_x[ci] - _row(av, j, 0) * _row(xi, j, 0))
            else:
                d_lo = eff_am(0) * (lo_x[ci] - _row(xi, j, -1))
                d_hi = eff_ap(n - 1) * (hi_x[ci] - _row(xi, j, 0))
            add_row(0, d_lo)
            add_row(n - 1, d_hi)
            # the global faces' surgery, on the edge blocks only
            lo_kind, up_kind = surgery[j]
            if coord[j] == 0:
                if lo_kind == "neumann":
                    add_row(1, eff_am(1) * ((4.0 / 3.0) * _row(xi, j, 1)
                                            - (1.0 / 3.0) * _row(xi, j, 2) - _row(xi, j, 0)))
                elif lo_kind == "periodic":
                    add_row(1, -eff_am(1) * _row(xi, j, 0))
            if coord[j] == ms[j] - 1:
                if up_kind == "neumann":
                    add_row(n - 2, eff_ap(n - 2) * ((4.0 / 3.0) * _row(xi, j, n - 2)
                                                    - (1.0 / 3.0) * _row(xi, j, n - 3)
                                                    - _row(xi, j, n - 1)))
                elif up_kind == "periodic":
                    add_row(n - 2, -eff_ap(n - 2) * _row(xi, j, n - 1))

    def kernel(xb, ab, bs):
        if kind == "div":
            return advect_pair(xb, ab, bs, limiter, surgery_local, form)
        return conv_component(xb, ab, bs, limiter, surgery_local)

    def apply(x, adv, base):
        if isinstance(x, BlockTensor):
            return _advect_placed(x, adv, base, kernel, block_fixes, conservative)
        out = torch.empty((vdim if kind == "conv" else 1, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        for coord, sl in decomp.blocks(x.shape[1:]):
            idx = (slice(None), *sl)
            xb, ab = x[idx].contiguous(), adv[idx].contiguous()
            bs = _block_coeffs(base, sl)
            o = kernel(xb, ab, bs)
            for j in range(nd):
                if cut[j]:
                    block_fixes(o, xb, ab, bs, coord, j, halo_exchange(x, sl, j),
                                halo_exchange(adv, sl, j) if conservative else None)
            out[idx] = o
        return out

    return apply


def _operand_faces(a: BlockTensor) -> list:
    """Per block of the operand block vector ``a`` (an advector or Γ, fixed
    for a solve), per grid axis, its ring neighbours' ``(lo, hi)`` faces
    copied to the block's device: made at the first call of ``a`` and kept
    on it (``device_cache.per_solve``), so an apply moves none of them."""
    def make():
        lay = a.placement
        return [[tuple(transfer(f, dev).contiguous() for f in _ghost_faces(a, b, j))
                 if lay.cut[j] else None for j in range(len(lay.grid))]
                for b, (_, _, dev) in enumerate(lay.blocks)]

    return per_solve(a, "faces", make)


def _advect_placed(x: BlockTensor, adv: BlockTensor, base, kernel, block_fixes,
                   conservative: bool) -> BlockTensor:
    """The placed Div/Conv apply: per block on its device, the kernel on the
    block (surgery "none" on cut axes), then the face-row patches with
    ``x``'s ghost faces from the ring neighbours (``exchange_bytes``) and,
    in conservative-central form, the advector's (made once per solve,
    ``_operand_faces``), and the global faces' surgery on the edge
    blocks."""
    global placed_applies
    lay = x.placement
    if not isinstance(adv, BlockTensor) or adv.placement is not lay:
        raise ValueError("halo: a placed Div/Conv apply needs the advector scattered to the "
                         "blocks of its target")
    per_block = block_coeffs(base, lay)
    a_faces = _operand_faces(adv) if conservative else None
    outs = []
    for b, (coord, _, dev) in enumerate(lay.blocks):
        xb, ab, bs = x.parts[b], adv.parts[b], per_block[b]
        o = kernel(xb, ab, bs)
        for j in range(len(lay.grid)):
            if lay.cut[j]:
                lo, hi = _ghost_faces(x, b, j)
                _count(dev, lo, hi)
                block_fixes(o, xb, ab, bs, coord, j, (transfer(lo, dev), transfer(hi, dev)),
                            a_faces[b][j] if conservative else None)
        outs.append(o)
    placed_applies += 1
    return BlockTensor(outs, lay, (outs[0].shape[0], *x.shape[1:]))


# -- placed variable-Γ apply and Γ-aware level pass ------------------------------


def field_sides(lay, b: int, wrap=()) -> tuple:
    """Per grid axis ``(lo, hi)``: whether block ``b``'s halo-extended buffer
    of the variable-Γ kernels takes a ghost row on that side: on a cut
    axis, every side that faces another block, and the global faces of a
    periodic (``wrap``) axis; never the global face of another axis, so
    that the kernels' Neumann surgery (rows 1 / -2) and end-row mask (rows
    0 / -1) land on the global rows there."""
    coord = lay.blocks[b][0]
    return tuple((int(lay.cut[j] and (coord[j] > 0 or j in wrap)),
                  int(lay.cut[j] and (coord[j] < lay.ms[j] - 1 or j in wrap)))
                 for j in range(len(lay.grid)))


def placed_field_supported(decomp, global_shape, wrap=()) -> bool:
    """Whether the placed variable-Γ apply and pass run this decomposition:
    a 2-D or 3-D grid, every axis divisible into its blocks, and every
    block's halo-extended buffer (``field_sides``) at least 3 nodes long
    on every axis (the kernels' minimum, ``ops.diff_field.check_inputs``).
    A level it rejects runs on the lead device (a counted gather)."""
    nd = len(global_shape)
    ms = tuple(decomp.mesh_shape) + (1,) * (nd - len(decomp.mesh_shape))
    if nd not in (2, 3) or len(ms) != nd or any(s % m for s, m in zip(global_shape, ms)):
        return False
    for j, (s, m) in enumerate(zip(global_shape, ms)):
        least = s // m + (0 if m == 1 else 2 if j in wrap else 1)
        if least < 3:
            return False
    return True


def field_ghost_bytes(lay, vdim: int, itemsize: int, wrap=()) -> int:
    """Bytes of ``x``'s ghost faces one placed variable-Γ apply moves: one
    face per extended side (``field_sides``) of every block."""
    total = 0
    for b, (_, sl, _) in enumerate(lay.blocks):
        ext = [s.stop - s.start for s in sl]
        for j, (lo, hi) in enumerate(field_sides(lay, b, wrap)):
            total += (lo + hi) * vdim * (prod(ext) // ext[j]) * itemsize
    return total


def _interior(sides, shape) -> tuple:
    return (slice(None),) + tuple(slice(lo, lo + n) for (lo, _), n in zip(sides, shape[1:]))


def _halo_block(x: BlockTensor, b: int, sides, buffers: dict, role: str, faces: bool = True,
                count: bool = True) -> torch.Tensor:
    """Block ``b`` of ``x`` in the halo-extended buffer of its shape, dtype
    and device for ``role`` in ``buffers`` (made at first use, then
    reused: blocks run in stream order), with (``faces``) one ghost row per
    side in ``sides`` copied from its ring neighbours (counted in
    ``exchange_bytes`` with ``count``)."""
    xb = x.parts[b]
    shape = (xb.shape[0],) + tuple(n + lo + hi for n, (lo, hi) in zip(xb.shape[1:], sides))
    key = (role, shape, xb.dtype, xb.device)
    if key not in buffers:
        # ones: a ghost corner is never read, but a Γ there stays positive
        buffers[key] = torch.ones(shape, dtype=xb.dtype, device=xb.device)
    buf = buffers[key]
    inner = list(_interior(sides, xb.shape))
    buf[tuple(inner)] = xb
    for j, (lo, hi) in enumerate(sides if faces else ()):
        if not (lo or hi):
            continue
        glo, ghi = _ghost_faces(x, b, j)
        if lo:
            copy_into(buf[tuple(inner[:1 + j] + [slice(0, 1)] + inner[2 + j:])], glo)
            if count:
                _count(xb.device, glo)
        if hi:
            copy_into(buf[tuple(inner[:1 + j] + [slice(shape[1 + j] - 1, None)] + inner[2 + j:])],
                      ghi)
            if count:
                _count(xb.device, ghi)
    return buf


def _block_surgery(surgery, lay, coord) -> tuple:
    """A block's surgery kinds: the global face's kind on the sides that lie
    on a global face, "none" on the sides that face another block."""
    return tuple((lo if not lay.cut[j] or coord[j] == 0 else "none",
                  up if not lay.cut[j] or coord[j] == lay.ms[j] - 1 else "none")
                 for j, (lo, up) in enumerate(surgery))


def _gamma_blocks(g: BlockTensor, wrap) -> list:
    """Per block of the Γ block vector ``g`` (``(1, *nx)`` isotropic or
    ``(dim, *nx)`` stacked), its halo-extended copy for the variable-Γ
    kernels (``field_sides``): isotropic as ``n``, stacked as ``(dim,
    *n)``; made once per Γ and periodic axes (``device_cache.per_solve``,
    kept on ``g``), so an apply moves only ``x``'s ghost faces."""
    def make():
        lay, out = g.placement, []
        for b in range(len(lay.blocks)):
            buf = _halo_block(g, b, field_sides(lay, b, wrap), {}, "gamma", count=False)
            out.append(buf[0] if g.shape[0] == 1 else buf)
        return out

    return per_solve(g, ("gamma", tuple(wrap)), make)


def placed_diff_field(x: BlockTensor, g: BlockTensor, inv_dx2, surgery, avg: str, wrap,
                      buffers: dict) -> BlockTensor:
    """``∂_j (Γ ∂_j x)`` of a block vector, block by block on each block's
    device: the ``diff_field`` kernel on the block's halo-extended buffer
    (``field_sides``; surgery on the sides that lie on a global face only)
    and the interior of its output kept (a view). ``g``: Γ scattered to the
    same blocks; ``wrap``: the periodic axes of the (torus-reduced) grid.
    The rows of a non-periodic global face hold what the solver's mask
    discards."""
    global placed_applies
    lay = x.placement
    gext = _gamma_blocks(g, wrap)
    outs = []
    for b, (coord, _, _) in enumerate(lay.blocks):
        sides = field_sides(lay, b, wrap)
        xe = _halo_block(x, b, sides, buffers, "x")
        oe = diff_field(xe, gext[b], inv_dx2, _block_surgery(surgery, lay, coord), avg)
        outs.append(oe[_interior(sides, x.parts[b].shape)])
    placed_applies += 1
    return BlockTensor(outs, lay, x.shape)


def placed_diff_jacobi(x, b: BlockTensor, g: BlockTensor, inv_dx2, surgery, avg: str,
                       omega: float, mask_axes, mode: str, buffers: dict) -> BlockTensor:
    """One variable-Γ V-cycle pass (``ops.diff_field.diff_jacobi``, ``mode``
    "smooth", "smooth0" — ``x`` None — or "resid") of block vectors, block
    by block: the kernel on the halo-extended buffers of ``x`` and ``b``
    (``b``'s ghost rows are never read by a kept point), the interior of
    its output kept. The periodic axes are those outside ``mask_axes``:
    the kernel masks the end rows of the buffer, which are the global
    faces' rows or ghost rows that are dropped."""
    global placed_applies
    lay = b.placement
    wrap = tuple(j for j in range(len(lay.grid)) if j not in mask_axes)
    gext = _gamma_blocks(g, wrap)
    outs = []
    for k, (coord, _, _) in enumerate(lay.blocks):
        sides = field_sides(lay, k, wrap)
        be = _halo_block(b, k, sides, buffers, "b", faces=False)
        xe = None if x is None else _halo_block(x, k, sides, buffers, "x")
        oe = diff_jacobi(xe, be, gext[k], inv_dx2, _block_surgery(surgery, lay, coord), avg,
                         omega, mask_axes, mode)
        outs.append(oe[_interior(sides, b.parts[k].shape)])
    placed_applies += 1
    return BlockTensor(outs, lay, b.shape)
