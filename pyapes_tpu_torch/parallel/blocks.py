"""Block-resident vectors of a placed domain decomposition (the port's
counterpart of an array committed to a ``NamedSharding``).

A ``Layout`` is where the blocks of one grid live: per block (row-major
block order, ``DomainDecomposition.placement``) its coordinate, its index
ranges and its device, and the lead device (the solve's, where the
Field's value stays). A ``BlockTensor`` is a wrapper subclass of
``torch.Tensor`` (the idiom of PyTorch's DTensor): it has the global shape
and dtype and reports the lead device, but holds no storage of its own;
``parts`` holds one tensor per block, each its own allocation on its
block's device. Its ``__torch_dispatch__`` runs

* every pointwise operation, and clone, copy, fills, ``*_like`` and dtype
  casts, block by block on each block's device: a plain operand is cut to
  the block where a dimension has the grid's length and broadcast where it
  has length 1, and copied to the block's device once per use (a 0-d
  operand on the lead device among them);
* sums, the mean and the max over every grid axis as per-block partials,
  moved to the lead device and combined there in block order (a fixed
  order: the same bits on every run);
* the views that keep every cut grid axis whole (an alias, a full slice,
  a slice of a grid axis every block holds whole, a select or slice of the
  leading component axis, a leading ``unsqueeze``) and the torus reduction
  of a seam layout (below) block by block: each block of the result is
  that view of the block, so writes through it reach the blocks (``x[0] =
  v``, ``x[0:1]``);
* ``torch.roll`` along a grid axis: each block's rows are its own and
  those of its ring neighbours the shift brings in (copied from their
  devices: ``|shift|`` rows per block face of a cut axis), and
  ``torch.stack`` / ``torch.cat`` of block vectors of one layout along a
  leading axis, block by block;
* a copy to another device (``.to``) and ``.cpu()`` / ``.numpy()`` /
  ``np.asarray`` / ``.item()`` assembled there from per-block copies
  (``host_gathers`` counts those that land on the host);
* anything else as GSPMD would insert an all-gather: the block vectors
  gathered on the lead device (``gathers`` counts each such gather), the
  operation run there, and a result of the grid's shape scattered back.
  Any other view of a block vector (a row of a grid axis) raises: writes
  through it would be lost; ``add_at`` / ``set_at`` write such rows block
  by block.

A block vector may have length 1 along grid axes (a broadcast operand such
as a per-axis row scale); its blocks then repeat along the cut ones, and
reductions and gathers read each value once.

A periodic axis of ``2^k + 1`` nodes (the duplicate seam node stored at
both ends) does not divide into its blocks, but its torus of ``2^k`` does:
the layout of such a grid is the torus' with the seam plane held by the
last block along that axis (``Layout.seam``). The torus reduction
``x[..., :-1, ...]`` of such a block vector is a view, block by block (the
last blocks' seam planes left out), on the torus' layout, and
``append_seam`` puts the seam back (one face copied from the first block to
the last along the axis).

``repartition`` moves a block vector to another cut of the same grid on
the same devices (a pencil layout, ``Layout.pencils``): each destination
block is built from slices of the source blocks, each copied straight
from its source block's device to its destination block's device (the
all-to-all GSPMD inserts for a contraction along a cut axis; nothing
passes through the lead device). ``scatter`` / ``gather`` move between a
tensor on any device (a host tensor among them: each block's slice is
copied straight to its device) and a block vector; ``put`` is the
counterpart of ``jax.device_put(x, dd.sharding(...))``, ``build`` makes
each block on its device from its index ranges (no whole tensor
anywhere); ``interior_mask`` builds the active-set mask block by block;
``apply_bcs_fn`` writes each BC's face rows into the blocks on that face.

Per card (``graph_loop.per_card()``, the form a ``sync: False`` solve
across cards captures as one CUDA graph per card): every scalar of a
solver loop is a ``Replicated`` tensor, one replica on each card that
holds blocks (``cards``), and a reduction puts each block's partial on
every card, where it is combined in block order: the same operations in
the same order as the lead device's combine, so every card holds the same
bits and decides the loop's exit itself. An operation on block vectors
takes a block's card's replica. Every copy between two devices goes
through ``copy_into`` / ``transfer``: inside a capture of one graph per
card, a ``ops.peer`` put on the source card and a wait on the destination
card (``transfers_across``); elsewhere a plain copy.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from pyapes_tpu_torch.ops import graph_loop, peer
from pyapes_tpu_torch.parallel.decomp import _resolve, pencil_plan

aten = torch.ops.aten

gathers = 0
"""Block vectors gathered on the lead device by an operation that does not
run block by block (a counter, like the kernels' ``launches``). The
entry's scatter and the exit's gather of a solve do not count. Like every
counter of this module it counts in Python: work captured into a CUDA
graph counts at the warm-up and at the capture, not at a replay."""
operand_scatters = 0
"""Whole operands of a placed solve scattered to its blocks
(``scatter_operand``: Γ, an advector): once each per solve, at its entry
or in its preconditioner's setup, never inside the Krylov loop (an
operand that is a block vector already is not scattered)."""
repartitions = 0
"""Block vectors moved to another cut of their grid (``repartition``)."""
repartition_bytes_across = 0
"""Bytes ``repartition`` copied from a block on one device to a block on
another."""
repartition_bytes_within = 0
"""Bytes ``repartition`` copied between two blocks on one device."""
host_gathers = 0
"""Block vectors assembled on the host from per-block copies (``.cpu()``,
``.numpy()``, ``np.asarray``, ``.item()``, ``host_gather``)."""
transfers_across = 0
"""Copies between two cards captured as an ``ops.peer`` put and wait
(``copy_into`` inside a capture of one graph per card)."""
transfer_bytes_across = 0
"""Their bytes."""


def copy_into(dst: torch.Tensor, src: torch.Tensor, across: bool | None = None) -> torch.Tensor:
    """``dst.copy_(src)``, the one way data moves between devices here:
    inside a capture of one graph per card (``graph_loop.lanes_capturing``)
    a copy between two cards is ``ops.peer``'s put on the source card's
    stream and its wait on the destination card's (counted in
    ``transfers_across``); ``across`` (default: the devices differ) marks a
    copy between two cards, which on the host (the CPU tests' stand-in,
    ``per_card(blocks_as_cards=True)``) runs the plain put and wait."""
    global transfers_across, transfer_bytes_across
    if across is None:
        across = src.device != dst.device
    if not across:
        return dst.copy_(src)
    if graph_loop.lanes_capturing():
        ch = peer.Channel.make(src.device, dst.device)
        peer.peer_put(src, dst, ch)
        peer.peer_wait(ch)
        transfers_across += 1
        transfer_bytes_across += src.numel() * src.element_size()
    elif src.device.type == "cpu" and dst.device.type == "cpu":
        peer.peer_put(src, dst)
        peer.peer_wait(None, "cpu")
    else:
        dst.copy_(src)
    return dst


def transfer(t: torch.Tensor, device, across: bool | None = None) -> torch.Tensor:
    """``t.to(device)`` through ``copy_into`` (``t`` itself where it lies
    on ``device`` and ``across`` is not set)."""
    device = torch.device(device)
    if across is None:
        across = t.device != device
    if not across:
        return t
    if not graph_loop.lanes_capturing() and t.device != device:
        return t.to(device)
    return copy_into(torch.empty(t.shape, dtype=t.dtype, device=device), t, across=True)


class Cards:
    """The holders of a replicated scalar of a placed decomposition
    (``cards``): ``devices`` one per replica, the lead's first; a block's
    holder is the replica on its device, or (``by_block``, the CPU
    stand-in) the block's own."""

    def __init__(self, devices, by_block: bool):
        self.devices = tuple(devices)
        self.by_block = by_block

    def holder(self, lay, b: int) -> int:
        return b if self.by_block else self.devices.index(lay.blocks[b][2])


_CARDS: dict = {}


def card_lanes(decomp, lead) -> tuple:
    """The lanes of a capture of one graph per card (``graph_loop.GraphedCall
    (fn, lead, lanes=...)``) that holds solves on the placed ``decomp`` led
    from ``lead``: the lead device, then every other device of the blocks in
    block order, the order of ``cards``' replicas; under the CPU tests'
    stand-in (``per_card(blocks_as_cards=True)``) one lane per block."""
    devices = tuple(torch.device(d) for d in decomp.devices)
    if graph_loop.per_card_mode() == "blocks":
        return devices
    return tuple(dict.fromkeys((torch.device(lead),) + devices))


def cards(lay) -> Cards | None:
    """The ``Cards`` of ``lay``'s decomposition under ``graph_loop.per_card``
    (its lead device, then every other device of its blocks in block
    order; per block under ``blocks_as_cards``), else None."""
    mode = graph_loop.per_card_mode()
    if mode is None:
        return None
    key = (lay.decomp, lay.lead, mode)
    if key not in _CARDS:
        _CARDS[key] = Cards(card_lanes(lay.decomp, lay.lead), mode == "blocks")
    return _CARDS[key]


class Replicated(torch.Tensor):
    """A tensor held once per card (``cards.devices``; ``parts``, the lead's
    first), every replica computed by the same operations: a solver loop's
    scalars under ``graph_loop.per_card``. An operation runs on every
    replica (a plain operand moved to each card, ``transfer``); an
    operation with block vectors takes each block's card's replica; a
    host read reads the lead's."""

    parts: tuple
    cards: Cards

    @staticmethod
    def __new__(cls, parts, cards_: Cards):
        p0 = parts[0]
        t = torch.Tensor._make_wrapper_subclass(cls, tuple(p0.shape), dtype=p0.dtype,
                                                device=p0.device, requires_grad=False)
        t.parts = tuple(parts)
        t.cards = cards_
        return t

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __repr__(self, *, tensor_contents=None):
        return (f"Replicated(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"replicas={len(self.parts)})")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = list(_leaves(args, kwargs))
        if any(isinstance(t, BlockTensor) for t in leaves):
            return NotImplemented
        reps = [t for t in leaves if isinstance(t, Replicated)]
        cs = reps[0].cards
        if any(r.cards is not cs for r in reps):
            raise ValueError("blocks: replicated scalars of two placements in one operation")
        if func is aten._local_scalar_dense.default:
            return func(args[0].parts[0])
        outs = []
        for h, dev in enumerate(cs.devices):
            def local(t, h=h, dev=dev):
                if isinstance(t, Replicated):
                    return t.parts[h]
                if isinstance(t, torch.Tensor):
                    return transfer(t, dev)
                return t

            kw = {k: tree_map(local, v) for k, v in kwargs.items()}
            if kw.get("device") is not None:
                kw["device"] = dev
            outs.append(func(*tree_map(local, list(args)), **kw))
        mutated = _mutated(func, args, kwargs)
        if mutated:
            return mutated[0] if len(mutated) == 1 else tuple(mutated)
        if isinstance(outs[0], torch.Tensor):
            return Replicated(outs, cs)
        if isinstance(outs[0], (tuple, list)):
            return type(outs[0])(Replicated([o[i] for o in outs], cs)
                                 if isinstance(outs[0][i], torch.Tensor) else outs[0][i]
                                 for i in range(len(outs[0])))
        return outs[0]


def lead_replica(t):
    """The lead card's replica of a ``Replicated`` tensor; anything else as
    it is."""
    return t.parts[0] if isinstance(t, Replicated) else t


def replicated(make, x):
    """``make(device)`` on every card of the block vector ``x`` under
    ``graph_loop.per_card`` (a ``Replicated``), else ``make(x.device)``."""
    cs = cards(x.placement) if isinstance(x, BlockTensor) else None
    if cs is None:
        return make(x.device)
    return Replicated([make(d) for d in cs.devices], cs)


def _combine_everywhere(partials, lay, cs: Cards, combine):
    """Per-block partials ``[(b, p), ...]`` (in block order, each on its
    block's device) combined on every card of ``cs`` in block order: each
    card stacks the partials of its own blocks once and puts the stack on
    every other card (``copy_into``), then every card folds them all with
    ``combine`` in block order, as the lead's combine does: the same bits
    on every card."""
    own: dict = {}
    for b, p in partials:
        own.setdefault(cs.holder(lay, b), []).append((b, p))
    stacks = {h: torch.stack([p for _, p in lst]) for h, lst in own.items()}
    out = []
    for g, dev in enumerate(cs.devices):
        got = {}
        for h, lst in own.items():
            st = stacks[h] if h == g else transfer(stacks[h], dev, across=True)
            for i, (b, _) in enumerate(lst):
                got[b] = st[i]
        acc = None
        for b, _ in partials:
            acc = got[b] if acc is None else combine(acc, got[b])
        out.append(acc)
    return Replicated(out, cs)


class Layout:
    """The blocks of a placed decomposition on one grid: ``blocks`` lists
    ``(coord, slices, device)`` per block, ``lead`` is the solve's
    device, ``ms`` the blocks per grid axis and ``cut`` the axes with more
    than one block. ``seam``: the cut axes whose ``n`` nodes do not divide
    into their blocks but whose torus of ``n - 1`` does; there the blocks
    are the torus', the last one along the axis one row longer (it holds
    the seam plane). Made once per decomposition, grid and lead device
    (``layout``), so identity compares two. Raises ``ValueError`` where an
    axis divides neither way."""

    def __init__(self, decomp, grid, lead):
        self.decomp = decomp
        self.grid = tuple(int(n) for n in grid)
        self.lead = torch.device(lead)
        self.ms = decomp.mesh_shape + (1,) * (len(self.grid) - len(decomp.mesh_shape))
        self.seam = tuple(j for j, (n, m) in enumerate(zip(self.grid, self.ms))
                          if m > 1 and n % m and (n - 1) % m == 0)
        torus = tuple(n - (j in self.seam) for j, n in enumerate(self.grid))
        self.blocks = tuple(
            (c, tuple(slice(s.start, s.stop + 1) if j in self.seam and c[j] == self.ms[j] - 1
                      else s for j, s in enumerate(sl)), d)
            for c, sl, d in decomp.placement(torus))
        self.cut = tuple(m > 1 for m in self.ms)
        self.devices = tuple(d for _, _, d in self.blocks)
        self._index = {c: i for i, (c, _, _) in enumerate(self.blocks)}
        self._pencils = None

    def pencils(self) -> tuple:
        """``((axis, Layout), ...)``: the layouts of ``decomp.pencil_plan``
        on this grid and lead device, in the order of the transforms (made
        at first use; ``NotImplementedError`` where a pencil cannot
        divide)."""
        if self._pencils is None:
            self._pencils = tuple((a, layout(self.decomp.pencil(ms), self.grid, self.lead))
                                  for a, ms in pencil_plan(self.ms, self.grid))
        return self._pencils

    def neighbour(self, b: int, j: int, step: int) -> int:
        """The block ``step`` blocks from block ``b`` along grid axis ``j``
        (the ring wraps)."""
        c = list(self.blocks[b][0])
        c[j] = (c[j] + step) % self.ms[j]
        return self._index[tuple(c)]

    def along(self, b: int, j: int, k: int) -> int:
        """The block at coordinate ``k`` along grid axis ``j`` in block
        ``b``'s row of blocks."""
        c = list(self.blocks[b][0])
        c[j] = k
        return self._index[tuple(c)]

    def fits(self, shape) -> bool:
        """Whether a tensor of ``shape`` broadcasts against the grid
        ``(vdim, *grid)`` block by block: right-aligned, every grid axis of
        the grid's length or 1."""
        off = 1 + len(self.grid) - len(shape)
        return off >= 0 and all(n in (1, self.grid[p + off - 1])
                                for p, n in enumerate(shape) if p + off >= 1)

    def index(self, shape, b: int) -> tuple:
        """Block ``b``'s index into a tensor of ``shape`` (``fits``): its
        range on every cut grid axis of the grid's length, the whole axis
        elsewhere."""
        sl = self.blocks[b][1]
        off = 1 + len(self.grid) - len(shape)
        idx = []
        for p, n in enumerate(shape):
            j = p + off - 1
            idx.append(sl[j] if j >= 0 and self.cut[j] and n == self.grid[j] else slice(None))
        return tuple(idx)

    def owners(self, shape) -> list[int]:
        """The blocks that hold each value of a block vector of ``shape``
        once: all of them, but along a cut axis where the vector has length
        1 only the first block."""
        off = 1 + len(self.grid) - len(shape)
        bcast = [j for j in range(len(self.grid))
                 if self.cut[j] and (j + 1 - off < 0 or shape[j + 1 - off] == 1)]
        return [b for b, (c, _, _) in enumerate(self.blocks) if all(c[j] == 0 for j in bcast)]


_LAYOUTS: dict = {}


def layout(decomp, grid, lead) -> Layout:
    """The ``Layout`` of ``decomp`` (placed) on ``grid`` with the lead
    device ``lead`` (made at first use, then the same object)."""
    key = (decomp, tuple(int(n) for n in grid), _resolve(lead))
    if key not in _LAYOUTS:
        _LAYOUTS[key] = Layout(decomp, key[1], key[2])
    return _LAYOUTS[key]


class BlockTensor(torch.Tensor):
    """A vector of the global ``shape`` held as one tensor per block of
    ``placement`` (``parts``, each on its block's device); see the module
    docstring."""

    parts: tuple
    placement: Layout

    @staticmethod
    def __new__(cls, parts, placement: Layout, shape):
        t = torch.Tensor._make_wrapper_subclass(cls, tuple(shape), dtype=parts[0].dtype,
                                                device=placement.lead, requires_grad=False)
        t.parts = tuple(parts)
        t.placement = placement
        return t

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __repr__(self, *, tensor_contents=None):
        devs = sorted({str(d) for d in self.placement.devices})
        return (f"BlockTensor(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"blocks={self.placement.ms}, devices={devs})")

    # the host's view of a block vector: assembled there from per-block copies
    def cpu(self, memory_format=torch.preserve_format) -> torch.Tensor:
        return host_gather(self)

    def numpy(self, *, force: bool = False):
        return host_gather(self).numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def item(self):
        return host_gather(self).item()

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        vecs = [t for t in _leaves(args, kwargs) if isinstance(t, BlockTensor)]
        lay = vecs[0].placement
        if any(v.placement is not lay for v in vecs):
            raise ValueError("blocks: block vectors of two placements in one operation")
        if func in _REDUCE:
            out = _reduce(func, args, kwargs, lay)
            if out is not NotImplemented:
                return out
        if func in _VIEWS:
            out = _view(func, args, kwargs, lay)
            if out is not NotImplemented:
                return out
        if func in _LAYOUT_OPS:
            out = _LAYOUT_OPS[func](args, kwargs, lay)
            if out is not NotImplemented:
                return out
        if func is aten._to_copy.default and kwargs.get("device") is not None \
                and _resolve(kwargs["device"]) != lay.lead:
            return _assemble(args[0], _resolve(kwargs["device"]),
                             kwargs.get("dtype") or args[0].dtype)
        if func is aten._local_scalar_dense.default:
            return host_gather(args[0]).item()
        if (func in _BLOCKWISE or torch.Tag.pointwise in func.tags) \
                and _mappable(func, args, kwargs, lay):
            return _map(func, args, kwargs, lay)
        return _fallback(func, args, kwargs, lay)


# operations without the pointwise tag that run block by block all the same
_BLOCKWISE = {
    aten.clone.default, aten.detach.default, aten.copy_.default, aten.fill_.Scalar,
    aten.fill_.Tensor, aten.zero_.default, aten.zeros_like.default, aten.ones_like.default,
    aten.empty_like.default, aten.full_like.default, aten._to_copy.default,
    aten.where.self_out,
}
_REDUCE = {aten.sum.default: torch.add, aten.sum.dim_IntList: torch.add,
           aten.max.default: torch.maximum}
_VIEWS = {aten.alias.default, aten.slice.Tensor, aten.select.int, aten.unsqueeze.default}


def _view(func, args, kwargs, lay: Layout):
    """A view that keeps every grid axis whole, block by block (the module
    docstring); NotImplemented for another one."""
    x, rest = args[0], list(args[1:])
    if kwargs or not isinstance(x, BlockTensor) or any(isinstance(a, torch.Tensor)
                                                       for a in rest):
        return NotImplemented
    lead = x.dim() - len(lay.grid)  # the leading (component) axes: 0 or 1
    shape = tuple(x.shape)
    if func is aten.alias.default:
        return BlockTensor([func(p) for p in x.parts], lay, shape)
    dim = rest[0] % (x.dim() + (func is aten.unsqueeze.default)) if rest else 0
    if func is aten.unsqueeze.default:
        if dim != 0 or lead != 0:
            return NotImplemented
        return BlockTensor([func(p, 0) for p in x.parts], lay, (1, *shape))
    if func is aten.select.int:
        if dim >= lead:
            return NotImplemented
        return BlockTensor([func(p, dim, rest[1]) for p in x.parts], lay,
                           shape[:dim] + shape[dim + 1:])
    # aten.slice.Tensor(x, dim, start, end, step)
    start, end, step = (rest[1:] + [None, None, 1][len(rest) - 1:])[:3]
    if dim >= lead:  # a grid axis: its whole range, or its torus (the seam left out)
        n = shape[dim]
        end = n if end is None else (end + n if end < 0 else min(end, n))
        start = start or 0
        start = start + n if start < 0 else start
        j = dim - lead
        if step != 1:
            return NotImplemented
        if start == 0 and end == n:
            return BlockTensor([aten.alias.default(p) for p in x.parts], lay, shape)
        if not lay.cut[j] and n == lay.grid[j]:  # an axis every block holds whole
            grid = lay.grid[:j] + (end - start,) + lay.grid[j + 1:]
            return BlockTensor([func(p, dim, start, end) for p in x.parts],
                               layout(lay.decomp, grid, lay.lead),
                               shape[:dim] + (end - start,) + shape[dim + 1:])
        if start == 0 and end == n - 1 and j in lay.seam:
            grid = lay.grid[:j] + (n - 1,) + lay.grid[j + 1:]
            parts = [p.narrow(dim, 0, p.shape[dim] - 1) if c[j] == lay.ms[j] - 1
                     else aten.alias.default(p) for p, (c, _, _) in zip(x.parts, lay.blocks)]
            return BlockTensor(parts, layout(lay.decomp, grid, lay.lead),
                               shape[:dim] + (n - 1,) + shape[dim + 1:])
        return NotImplemented
    parts = [func(p, dim, start, end, step) for p in x.parts]
    return BlockTensor(parts, lay, shape[:dim] + (parts[0].shape[dim],) + shape[dim + 1:])


def _same_layout(ts, lay: Layout) -> bool:
    return all(isinstance(t, BlockTensor) and t.placement is lay for t in ts)


def _stack(args, kwargs, lay: Layout):
    """``torch.stack`` of block vectors of one layout and shape along a
    leading axis, block by block."""
    ts = list(args[0])
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    if not _same_layout(ts, lay) or any(t.shape != ts[0].shape for t in ts):
        return NotImplemented
    nd = ts[0].dim()
    dim %= nd + 1
    if dim > nd - len(lay.grid):
        return NotImplemented
    parts = [torch.stack([t.parts[b] for t in ts], dim) for b in range(len(lay.blocks))]
    shape = tuple(ts[0].shape)
    return BlockTensor(parts, lay, shape[:dim] + (len(ts),) + shape[dim:])


def _cat(args, kwargs, lay: Layout):
    """``torch.cat`` of block vectors of one layout along a leading axis,
    block by block."""
    ts = list(args[0])
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    if not _same_layout(ts, lay):
        return NotImplemented
    nd = ts[0].dim()
    dim %= nd
    if dim >= nd - len(lay.grid):
        return NotImplemented
    parts = [torch.cat([t.parts[b] for t in ts], dim) for b in range(len(lay.blocks))]
    shape = tuple(ts[0].shape)
    return BlockTensor(parts, lay, shape[:dim] + (sum(t.shape[dim] for t in ts),)
                       + shape[dim + 1:])


def _mean(args, kwargs, lay: Layout):
    """The mean over every value: the sum of per-block partials (in block
    order) over the count."""
    x = args[0]
    if len(args) > 1 or set(kwargs) - {"dtype"}:
        return NotImplemented
    total = _reduce(aten.sum.default, (x,), kwargs, lay)
    if total is NotImplemented:
        return total
    return total / x.numel()


def _roll(args, kwargs, lay: Layout):
    """``torch.roll`` along grid or leading axes: along a cut grid axis each
    block is assembled from the rows of the blocks the shift brings in (its
    own and its ring neighbours', copied from their devices), along
    another axis each block is rolled as it is."""
    x = args[0]
    shifts = args[1] if len(args) > 1 else kwargs["shifts"]
    dims = args[2] if len(args) > 2 else kwargs.get("dims", ())
    shifts = [shifts] if isinstance(shifts, int) else list(shifts)
    dims = [dims] if isinstance(dims, int) else list(dims)
    if not isinstance(x, BlockTensor) or not dims or len(dims) != len(shifts):
        return NotImplemented
    lead = x.dim() - len(lay.grid)
    for s, dim in zip(shifts, dims):
        dim %= x.dim()
        j = dim - lead
        if j < 0 or not lay.cut[j] or x.shape[dim] == 1:
            x = BlockTensor([torch.roll(p, s, dim) for p in x.parts], lay, x.shape)
            continue
        n = x.shape[dim]
        parts = []
        for b, (_, sl, dev) in enumerate(lay.blocks):
            pieces, i = [], sl[j].start
            while i < sl[j].stop:
                src = (i - s) % n
                k = next(k for k in range(lay.ms[j])
                         if lay.blocks[lay.along(b, j, k)][1][j].stop > src)
                o = lay.along(b, j, k)
                o_sl = lay.blocks[o][1][j]
                m = min(sl[j].stop - i, o_sl.stop - src)
                pieces.append(transfer(x.parts[o].narrow(dim, src - o_sl.start, m), dev))
                i += m
            parts.append(torch.cat(pieces, dim))
        x = BlockTensor(parts, lay, x.shape)
    return x


_LAYOUT_OPS = {aten.stack.default: _stack, aten.cat.default: _cat, aten.mean.default: _mean,
               aten.roll.default: _roll}


def append_seam(x, axis: int):
    """``torch.cat([x, x.narrow(axis, 0, 1)], dim=axis)``: a torus-reduced
    vector with its duplicate seam plane put back at the end of ``axis``.
    Of a block vector, block by block onto the layout of the grid one node
    longer (``Layout.seam``): the last block along the axis takes the first
    block's first plane (one face copied from its device), the others are
    copied as they are."""
    if not isinstance(x, BlockTensor):
        return torch.cat([x, x.narrow(axis, 0, 1)], dim=axis)
    lay = x.placement
    j = axis % x.dim() - (x.dim() - len(lay.grid))
    grid = lay.grid[:j] + (lay.grid[j] + 1,) + lay.grid[j + 1:]
    to = layout(lay.decomp, grid, lay.lead)
    parts = []
    for b, (c, _, dev) in enumerate(lay.blocks):
        p = x.parts[b]
        if c[j] == lay.ms[j] - 1:
            first = transfer(x.parts[lay.along(b, j, 0)].narrow(axis, 0, 1), dev)
            parts.append(torch.cat([p, first], dim=axis))
        else:
            parts.append(p.clone())
    shape = list(x.shape)
    shape[axis] += 1
    return BlockTensor(parts, to, tuple(shape))


def _assemble(x, device: torch.device, dtype) -> torch.Tensor:
    """The block vector ``x`` as one tensor on ``device`` (not its lead
    device), in ``dtype``: each block copied there once, nothing through
    the lead device; counted in ``host_gathers`` for the host, in
    ``gathers`` for another device."""
    global host_gathers, gathers
    lay = x.placement
    out = torch.empty(x.shape, dtype=dtype, device=device)
    for b in lay.owners(x.shape):
        out[lay.index(x.shape, b)].copy_(x.parts[b])
    if device.type == "cpu":
        host_gathers += 1
    else:
        gathers += 1
    return out


def host_gather(x) -> torch.Tensor:
    """A block vector as one tensor on the host (``_assemble``; counted in
    ``host_gathers``); a plain tensor's ``.cpu()``."""
    if not isinstance(x, BlockTensor):
        return x.cpu()
    return _assemble(x, torch.device("cpu"), x.dtype)


def _leaves(args, kwargs):
    """The arguments of an aten operation, lists opened (one level: the
    schemas nest no deeper)."""
    for a in (*args, *kwargs.values()):
        if isinstance(a, (list, tuple)):
            yield from a
        else:
            yield a


def _mutated(func, args, kwargs) -> list:
    """The arguments ``func`` writes (an in-place operation's self, an
    ``out=``)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            out.append(kwargs[a.name] if a.name in kwargs else args[i])
    return out


def _mappable(func, args, kwargs, lay: Layout) -> bool:
    if not all(isinstance(m, BlockTensor) for m in _mutated(func, args, kwargs)):
        return False
    return all(lay.fits(t.shape) for t in _leaves(args, kwargs)
               if isinstance(t, torch.Tensor) and not isinstance(t, BlockTensor))


def _map(func, args, kwargs, lay: Layout):
    moved: dict = {}
    parts = []
    for b, (_, _, dev) in enumerate(lay.blocks):
        def local(t, b=b, dev=dev):
            if isinstance(t, BlockTensor):
                return t.parts[b]
            if isinstance(t, Replicated):  # the replica on the block's card
                return t.parts[t.cards.holder(lay, b)]
            if not isinstance(t, torch.Tensor):
                return t
            idx = lay.index(t.shape, b)
            key = (id(t), tuple((s.start, s.stop) for s in idx), dev)
            if key not in moved:  # once per use and device
                moved[key] = transfer(t[idx], dev)
            return moved[key]

        kw = {k: local(v) for k, v in kwargs.items()}
        if "device" in kw:
            kw["device"] = dev
        parts.append(func(*[local(a) for a in args], **kw))
    mutated = _mutated(func, args, kwargs)
    if mutated:
        return mutated[0] if len(mutated) == 1 else tuple(mutated)
    tensors = [t for t in _leaves(args, {}) if isinstance(t, torch.Tensor)]
    shape = tensors[0].shape
    if torch.Tag.pointwise in func.tags and any(t.shape != shape for t in tensors):
        shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    return BlockTensor(parts, lay, shape)


def _reduce(func, args, kwargs, lay: Layout):
    """A reduction over every grid axis: per-block partials combined on the
    lead device in block order; NotImplemented for another one."""
    x = args[0]
    if not isinstance(x, BlockTensor) or any(
            isinstance(t, torch.Tensor) for t in _leaves(args[1:], kwargs)):
        return NotImplemented
    if func is aten.sum.dim_IntList:
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        dims = {d % x.dim() for d in dims} if dims else set(range(x.dim()))
        if not set(range(1, x.dim())) <= dims:
            return NotImplemented
    combine = _REDUCE[func]
    cs = cards(lay)
    if cs is not None:  # combined on every card
        return _combine_everywhere([(b, func(x.parts[b], *args[1:], **kwargs))
                                    for b in lay.owners(x.shape)], lay, cs, combine)
    acc = None
    for b in lay.owners(x.shape):
        p = func(x.parts[b], *args[1:], **kwargs).to(lay.lead)
        acc = p if acc is None else combine(acc, p)
    return acc


def _fallback(func, args, kwargs, lay: Layout):
    """Gather on the lead device, run there, scatter a grid-shaped result
    back (and write back the block vectors the operation writes)."""
    mutated = _mutated(func, args, kwargs)
    if not mutated and any(r.alias_info is not None for r in func._schema.returns):
        raise NotImplementedError(f"blocks: {func} would be a view of a block vector; gather it "
                                  "first (blocks.gather)")
    full: dict = {}

    def gat(t):
        if isinstance(t, BlockTensor):
            if id(t) not in full:
                full[id(t)] = gather(t)
            return full[id(t)]
        return t

    out = func(*tree_map(gat, args), **tree_map(gat, kwargs))
    for m in mutated:
        if isinstance(m, BlockTensor):
            for b, part in enumerate(m.parts):
                part.copy_(full[id(m)][lay.index(m.shape, b)])
    if mutated:
        return mutated[0] if len(mutated) == 1 else tuple(mutated)
    if func is aten._to_copy.default:
        return out  # to another device: a plain tensor there

    def back(t):
        if (isinstance(t, torch.Tensor) and t.dim() == 1 + len(lay.grid) and t.device == lay.lead
                and lay.fits(t.shape) and any(n > 1 for n in t.shape[1:])):
            return scatter(t, lay)
        return t

    return tree_map(back, out)


def scatter(t: torch.Tensor, lay: Layout) -> BlockTensor:
    """``t`` (a tensor on any device whose shape ``lay.fits``, of rank 1 +
    the grid's) as a block vector of ``lay``: each block's slice copied
    straight into its own allocation on its device (from a host tensor,
    no whole tensor lands on a card). A block vector of ``lay`` comes back
    as it is; one on another layout of the same grid is moved there
    (``repartition``, counted), one of another grid gathered (counted)."""
    if isinstance(t, BlockTensor):
        if t.placement is lay:
            return t
        if t.placement.grid == lay.grid and tuple(t.shape[1:]) == lay.grid:
            return repartition(t, lay)
        t = gather(t)
    shape = tuple(t.shape)
    if len(shape) != 1 + len(lay.grid) or not lay.fits(shape):
        raise ValueError(f"blocks: a {shape} tensor does not scatter over the grid {lay.grid}")
    parts = []
    for b, (_, _, dev) in enumerate(lay.blocks):
        src = t[lay.index(shape, b)]
        parts.append(copy_into(torch.empty(src.shape, dtype=t.dtype, device=dev), src))
    return BlockTensor(parts, lay, shape)


def put(t, decomp) -> BlockTensor:
    """``t`` (a tensor or array ``(vdim, *grid)``, on any device) as a block
    vector of the placed ``decomp`` on its grid, the counterpart of the JAX
    package's ``jax.device_put(t, decomp.sharding(t.ndim))``: ``scatter``
    to ``layout(decomp, grid, lead)`` with the first block's device as the
    lead (where the block vector reports itself)."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t)
    if not decomp.placed:
        raise ValueError("blocks.put: the decomposition is not placed (give it devices)")
    return scatter(t, layout(decomp, t.shape[1:], decomp.devices[0]))


def build(lay: Layout, make) -> BlockTensor:
    """A block vector of ``lay`` made block by block: ``make(slices,
    device)`` returns the block at the index ranges ``slices`` (one slice per
    grid axis), ``(vdim, *block shape)``, on ``device``. No whole tensor is
    made anywhere (a manufactured right-hand side from the mesh's 1-D
    coordinates, the initial zeros of a Field too large for one card)."""
    parts = [make(sl, dev) for _, sl, dev in lay.blocks]
    return BlockTensor(parts, lay, (parts[0].shape[0], *lay.grid))


def _local(lay: Layout, shape, idx, b: int):
    """Block ``b``'s part of the basic index ``idx`` (ints and slices of step
    1, one per leading axis of a tensor of ``shape``) into a block vector of
    ``shape``: ``(index into the block, index into the selected values)``,
    or None where the block holds none of it."""
    off = len(shape) - len(lay.grid)
    idx = tuple(idx) + (slice(None),) * (len(shape) - len(idx))
    sl = lay.blocks[b][1]
    loc, val = [], []
    for p, (i, n) in enumerate(zip(idx, shape)):
        j = p - off
        lo, hi = (sl[j].start, sl[j].stop) if j >= 0 and lay.cut[j] and n == lay.grid[j] \
            else (0, n)
        if isinstance(i, slice):
            a, e, step = i.indices(n)
            assert step == 1, "blocks: slices of step 1"
            a0, e0 = max(a, lo), min(e, hi)
            if a0 >= e0:
                return None
            loc.append(slice(a0 - lo, e0 - lo))
            val.append(slice(a0 - a, e0 - a))
        else:
            i = int(i) % n
            if not lo <= i < hi:
                return None
            loc.append(i - lo)
    return tuple(loc), tuple(val)


def _selection(shape, idx) -> tuple:
    """The shape of ``x[idx]`` for a tensor of ``shape`` and a basic index
    (ints and slices), computed without a tensor."""
    out = []
    idx = tuple(idx) + (slice(None),) * (len(shape) - len(idx))
    for i, n in zip(idx, shape):
        if isinstance(i, slice):
            out.append(len(range(*i.indices(n))))
    return tuple(out)


def add_at(x, idx, value) -> None:
    """``x[idx] += value`` in place: on a block vector block by block, each
    block adding its part of ``value`` (broadcast to the selection, e.g. a
    number, a 0-d tensor or a face; moved to the block's device) at its
    rows of the basic index ``idx`` (ints and slices of step 1); on a plain
    tensor as written."""
    _write_at(x, idx, value, add=True)


def set_at(x, idx, value) -> None:
    """``x[idx] = value`` in place, as ``add_at`` writes."""
    _write_at(x, idx, value, add=False)


def _write_at(x, idx, value, add: bool) -> None:
    if not isinstance(x, BlockTensor):
        if add:
            x[idx] += value
        else:
            x[idx] = value
        return
    lay = x.placement
    sel = _selection(x.shape, idx)
    v = torch.as_tensor(value, dtype=x.dtype)
    v = v.expand(sel) if v.dim() else v
    for b, (_, _, dev) in enumerate(lay.blocks):
        loc = _local(lay, x.shape, idx, b)
        if loc is not None:
            part = transfer(v[loc[1]] if v.dim() else v, dev)
            if add:
                x.parts[b][loc[0]] += part
            else:
                x.parts[b][loc[0]] = part


def take(x, idx) -> torch.Tensor:
    """``x[idx]`` (a basic index, ints and slices of step 1) as a plain tensor
    on the lead device, assembled from the blocks' pieces of the selection
    (a face or a row: no whole tensor; not a view); of a plain tensor, the
    view ``x[idx]``."""
    if not isinstance(x, BlockTensor):
        return x[idx]
    lay = x.placement
    out = torch.empty(_selection(x.shape, idx), dtype=x.dtype, device=lay.lead)
    for b in lay.owners(x.shape):
        loc = _local(lay, x.shape, idx, b)
        if loc is not None:
            copy_into(out[loc[1]], x.parts[b][loc[0]])
    return out


def scatter_operand(t: torch.Tensor, lay: Layout) -> BlockTensor:
    """An operand of a placed solve (Γ, isotropic ``nx`` or stacked ``(dim,
    *nx)``, or an advector ``(c, *nx)``) scattered to the blocks of ``lay``
    (``scatter``; an isotropic Γ as ``(1, *nx)``), counted in
    ``operand_scatters``. The block vector keeps ``t`` (``lead_copy``): an
    operand is never written, so the lead device's copy stays its value."""
    global operand_scatters
    out = scatter(t[None] if t.dim() == len(lay.grid) else t, lay)
    operand_scatters += 1
    out.__dict__.setdefault("_per_solve", {})["lead"] = t
    return out


def lead_copy(t):
    """The tensor on the lead device that the operand block vector ``t`` was
    scattered from (``scatter_operand``; no copy), a counted ``gather`` of
    another block vector, anything else as it is."""
    if not isinstance(t, BlockTensor):
        return t
    kept = t.__dict__.get("_per_solve", {}).get("lead")
    return gather(t) if kept is None else kept


def move_parts(parts: list, src: Layout, to: Layout, shape) -> list:
    """The blocks of a block vector of ``shape`` (every grid axis whole
    length) held in ``parts`` (in ``src``'s block order) cut as ``to``'s:
    per destination block one allocation on its device, filled with the
    slices of the source blocks it overlaps, each copied straight from the
    source block's device (``repartition_bytes_across`` /
    ``_within``). An entry of ``parts`` is set to None after its last
    use, so a list the caller owns frees each source block as soon as it
    is copied out."""
    global repartitions, repartition_bytes_across, repartition_bytes_within
    if tuple(shape[1:]) != src.grid or to.grid != src.grid:
        raise ValueError(f"blocks: a {tuple(shape)} block vector does not repartition from the "
                         f"grid {src.grid} to {to.grid}")

    def overlap(a, b):
        box = tuple((max(s.start, t.start), min(s.stop, t.stop)) for s, t in zip(a, b))
        return box if all(lo < hi for lo, hi in box) else None

    def local(box, sl):
        return (slice(None),) + tuple(slice(lo - s.start, hi - s.start)
                                      for (lo, hi), s in zip(box, sl))

    last = {}
    for d, (_, dsl, _) in enumerate(to.blocks):
        for b, (_, ssl, _) in enumerate(src.blocks):
            if overlap(dsl, ssl):
                last[b] = d
    dtype, out = parts[0].dtype, []
    for d, (_, dsl, ddev) in enumerate(to.blocks):
        part = torch.empty((shape[0], *(s.stop - s.start for s in dsl)), dtype=dtype, device=ddev)
        for b, (_, ssl, sdev) in enumerate(src.blocks):
            box = overlap(dsl, ssl)
            if box is None:
                continue
            piece = parts[b][local(box, ssl)]
            copy_into(part[local(box, dsl)], piece)
            n = piece.numel() * piece.element_size()
            if sdev == ddev:
                repartition_bytes_within += n
            else:
                repartition_bytes_across += n
            if last[b] == d:
                parts[b] = None
        out.append(part)
    repartitions += 1
    return out


def repartition(x: BlockTensor, to: Layout) -> BlockTensor:
    """The block vector ``x`` (every grid axis whole length) on ``to``, a
    layout of the same grid (a pencil of ``x.placement``, or any other
    cut): ``move_parts``. ``x`` itself is left as it is; ``x`` comes back
    when it is already on ``to``."""
    if x.placement is to:
        return x
    return BlockTensor(move_parts(list(x.parts), x.placement, to, x.shape), to, x.shape)


def gather(x, count: bool = True, out=None) -> torch.Tensor:
    """A block vector as one tensor on its lead device (anything else comes
    back as it is); ``count``: add one to ``gathers`` (a solve's exit
    gather does not count); ``out``: a tensor of ``x``'s shape on the lead
    device to write into (a donated initial guess's storage)."""
    global gathers
    if not isinstance(x, BlockTensor):
        return x
    if count:
        gathers += 1
    lay = x.placement
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=lay.lead)
    for b in lay.owners(x.shape):
        copy_into(out[lay.index(x.shape, b)], x.parts[b])
    return out


def via_lead(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` of a block vector computed on the lead device (one counted
    gather) and scattered back; ``fn(x)`` of anything else."""
    if not isinstance(x, BlockTensor):
        return fn(x)
    return scatter(fn(gather(x)), x.placement)


def l2_per_dim(x: BlockTensor) -> torch.Tensor:
    """Per-component 2-norm over the grid: per-block norms, their squares
    summed on the lead device in block order, the root taken there."""
    lay = x.placement

    def sq(p):
        n = torch.linalg.vector_norm(p.reshape(p.shape[0], -1), dim=1)
        return n * n

    cs = cards(lay)
    if cs is not None:  # combined on every card
        return torch.sqrt(_combine_everywhere([(b, sq(x.parts[b])) for b in lay.owners(x.shape)],
                                              lay, cs, torch.add))
    acc = None
    for b in lay.owners(x.shape):
        s = sq(x.parts[b]).to(lay.lead)
        acc = s if acc is None else acc + s
    return torch.sqrt(acc)


def interior_mask(lay: Layout, slicer, dtype) -> BlockTensor:
    """The 0/1 mask ``(1, *grid)`` of the index ranges ``slicer`` (one
    slice of step 1 per grid axis), built block by block on each block's
    device as the outer product of per-axis vectors (the values of
    ``mesh.tools.interior_mask_device``; no global tensor is made)."""
    parts = []
    for _, sl, dev in lay.blocks:
        m = None
        for j, (s, bs) in enumerate(zip(slicer, sl)):
            a0, a1, step = s.indices(lay.grid[j])
            assert step == 1, "blocks.interior_mask: slices of step 1"
            v = torch.zeros(bs.stop - bs.start, dtype=dtype, device=dev)
            lo, hi = max(a0, bs.start), min(a1, bs.stop)
            if hi > lo:
                v[lo - bs.start:hi - bs.start] = 1.0
            v = v.reshape([-1 if k == j else 1 for k in range(len(sl))])
            m = v if m is None else m * v
        parts.append(m.expand(tuple(s.stop - s.start for s in sl)).contiguous()[None])
    return BlockTensor(parts, lay, (1, *lay.grid))


def _face_part(v, sl, a: int, dev, lay: Layout):
    """A BC value (a number, a 0-d tensor or a face tensor over the grid
    axes other than ``a``) cut to the block at ``sl`` and on ``dev``."""
    if not isinstance(v, torch.Tensor):
        return v
    others = [j for j in range(len(lay.grid)) if j != a]
    off = len(others) - v.dim()
    idx = tuple(sl[others[p + off]] if lay.cut[others[p + off]]
                and n == lay.grid[others[p + off]] else slice(None)
                for p, n in enumerate(v.shape))
    return transfer(v[idx], dev)


_OBSTACLES = ("obstacle_dirichlet", "obstacle_neumann")

per_iteration_gathers = 0
"""Block vectors gathered on the lead device for a BC whose value is
resolved per application (``per_iteration``; also counted in
``gathers``)."""


def apply_bcs_fn(bcs, grid, lay: Layout, plain):
    """``plain`` (``variables.bcs.apply_bcs_fn(bcs, grid)``) on a plain
    tensor; on a block vector of ``lay``, each BC writes the face rows of
    the blocks on its face, with its streamed values cut to the block and
    moved to its device (one clone of the vector per call, none with
    ``inplace``); an immersed obstacle applies block by block (its own
    ``apply_``). A BC whose value is resolved per application
    (``per_iteration``: a callable that reads the iterate) gets the
    iterate through one counted gather on the lead device per application
    (``per_iteration_gathers``, ``gathers``): the callable may read any of
    it, so nothing less is enough; only the face rows its value yields
    are then cut to the blocks. Raises ``ValueError`` where a face's blocks are thinner than the
    rows its BC reads and writes (Neumann 3, Symmetry 2, Dirichlet 1). A
    periodic upper face copies the first block's first plane along its
    axis onto the last block's last plane (the seam), the lower face is a
    no-op, as ``variables.bcs.Periodic``."""
    for bc in bcs:
        a = bc.bc_face_dim
        if bc.bc_type in _OBSTACLES:
            continue
        rows = {"neumann": 3, "symmetry": 2}.get(bc.bc_type, 1)  # the rows a BC reads/writes
        if lay.cut[a] and lay.grid[a] // lay.ms[a] < rows:
            raise ValueError(f"blocks: the blocks along axis {a} are too thin for its "
                             f"{bc.bc_type} rows")

    def apply_all(x, bc_vals=None, inplace: bool = False):
        global per_iteration_gathers
        if not isinstance(x, BlockTensor):
            return plain(x, bc_vals, inplace)
        if not inplace:
            x = x.clone()
        for i, bc in enumerate(bcs):
            vals = None if bc_vals is None else bc_vals[i]
            if bc.bc_type in _OBSTACLES:
                bc.apply_(x, grid, vals=vals)
                continue
            if bc.bc_type == "periodic":
                a = bc.bc_face_dim
                for b, (coord, _, dev) in enumerate(lay.blocks):
                    if bc.bc_n_dir > 0 and coord[a] == lay.ms[a] - 1:
                        src = x.parts[lay.along(b, a, 0)].select(1 + a, 0)
                        copy_into(x.parts[b].select(1 + a, -1), src)
                continue
            if vals is None and not bc.streamable and bc.bc_type != "symmetry":
                # per_iteration: the value of the iterate as it is now
                full = gather(x)
                per_iteration_gathers += 1
                i0 = 0 if bc.bc_n_dir < 0 else -1
                vals = tuple(bc._value_row(full, grid, d, i0) for d in range(x.shape[0]))
            a = bc.bc_face_dim
            edge = 0 if bc.bc_n_dir < 0 else lay.ms[a] - 1
            for b, (coord, sl, dev) in enumerate(lay.blocks):
                if coord[a] == edge:
                    bvals = None if vals is None else tuple(_face_part(v, sl, a, dev, lay)
                                                            for v in vals)
                    bc.apply_(x.parts[b], grid, vals=bvals)
        return x

    return apply_all
