"""Whole-step fusion for transient models: the step as CUDA graphs,
captured once and replayed (port of ``pyapes_tpu/utils/fuse.py``).

Why: an eager step of the port is host-bound. Its kernels keep the card
busy for a few ms of a step that takes 4-10 times as long on the host
(launches, the solver loops' per-iteration reads, uploads). On the TPU the
fix was one XLA program per step; its CUDA counterpart is a graph: the
step is captured once and replayed, and the solver loops inside it are
WHILE nodes whose exit the device decides (``ops/graph_loop.py``).

One graph per step where the model's state and solves lie on one card.
Where its solves are placed over blocks on several cards (a
``DomainDecomposition`` with ``devices`` on more than one card, the state
whole on the lead card or on the blocks), a WHILE body cannot span two
cards, so the step is one graph PER CARD, captured together
(``GraphedCall(..., lanes=blocks.card_lanes(decomp, lead))``, the lead
card first) and replayed side by side, each lane's graph launched from a
thread of its own, with no host wait for the cards: the core runs in
the per-card form (``graph_loop.per_card``: every scalar of a solve and
every reduction of a block vector replicated on each card, combined there
in block order; every move between cards an ``ops.peer`` put and wait), so
each card's graph holds its blocks' work and its own replica of every
loop's exit. The lead card's graph holds the glue on a whole state and the
solves' entry scatters and exit gathers (puts and waits too). The step's
bits are the eager step's.

Mechanics, as in the JAX package (state-swap capture): the model mutates
its ``Field`` objects, so ``FusedStepRunner``'s core (1) swaps the state
tensors into the live fields, (2) runs the model's unmodified ``step``,
(3) returns the fields' new tensors, and (4) restores the pre-step state
(the ``_VARoo`` a first step creates included), the clocks and the
model's attributes in a ``finally``, so neither a capture nor a failed
one changes the model. The state is what the ``Field`` history carries
(``_VAR``/``_VARo``/``_VARoo``) plus the clocks; ``t`` streams as a 0-d
float64 tensor on the lead card that the step reads (a block on another
card reads it through a put, as any operand from the lead card), so a
time-varying BC callable written with torch operations rides the graphs.

On the card each ``(dt, diag_fn)`` gets one program (a small LRU): an
eager warm-up of the core on the live state (kernels load, device
constants are cached, solver loops run on the host; the state is restored
after it), then the capture on static copies of the state, ending with
the copies that write the new state back into those copies (the history
shift, a pointer swap when eager, becomes copies in the graph; a block
state's copies block by block, each on its own card), then a replay per
step. ``dt`` is baked: the port builds some operands from it on the host
(the ddt coefficient, ``div/dt``), so a new ``dt`` is one more capture,
where the JAX program streams it. An operation that cannot be captured
raises ``CaptureError`` (the torch ``RuntimeError`` re-raised), the model
state untouched; ``model.run(fused=True)`` then falls back to eager steps.

On a CPU tensor the runner runs the same state-swap core with the
solvers at ``sync: False`` and no capture: the plain version (a
``GraphedCall``'s call on the CPU, on the step's lanes: under the CPU
tests' stand-in for cards, ``per_card(blocks_as_cards=True)``, the
per-card form with a lane per block).

The solvers' ``sync`` flags are off only for the duration of a fused call
and restored afterwards. The host clocks after a fused step advance only
for the fields the step advances (recorded by the core), so fused and
eager runs leave the same field metadata.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from pyapes_tpu_torch.ops.graph_loop import (
    CaptureError,
    GraphedCall,
    capturing,
    per_card,
    per_card_mode,
    whole_step,
)
from pyapes_tpu_torch.parallel import blocks
from pyapes_tpu_torch.solver.linalg.dispatch import lanes_across
from pyapes_tpu_torch.solver.ops import Solver, solve_log

__all__ = ["CaptureError", "FusedStepRunner"]

_ABSENT = object()


def _solvers_of(model) -> list:
    """Every Solver instance hanging off the model (their reports are
    cleared after a core, so nothing reads a capture's tensors later)."""
    return [v for v in vars(model).values() if isinstance(v, Solver)]


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return tree


def _stack(diags: list):
    """Per-step diagnostics pytrees stacked along a new leading axis."""
    first = diags[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(diags)
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([d[i] for d in diags]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([d[k] for d in diags]) for k in first}
    return first


class _Program:
    """The captured step of one ``(dt, diag_fn)``: the graph, the state
    slots it reads and writes in place, and what nothing else keeps alive."""

    def __init__(self, call, slots, attrs):
        self.call = call
        self.slots = slots  # (field index, level) of each static state input
        self.attrs = attrs


class FusedStepRunner:
    """Run ``model.step(dt)`` — glue and solves — as one graph per step (one
    per card where the solves are placed across cards).

    Args:
        model: a transient model exposing ``step(dt)`` and
            ``state_fields()``; ``model.t`` is kept as a host float.
        donate: bind the fields to the graph's own state buffers, which each
            replay updates in place (no copies outside the graph; a tensor
            held from before a step sees the step's values). Off: the fields
            get copies after each replay, and earlier tensors stay as they
            were.
    """

    _PROGRAMS_MAX = 4

    def __init__(self, model, fields=None, donate: bool = False):
        self.model = model
        self.fields = list(fields if fields is not None else model.state_fields())
        self._donate = bool(donate)
        # programs by (dt, diag_fn id), made at the first step
        self._compiled: OrderedDict | None = None
        self._hist_advanced = [True] * len(self.fields)
        self._t_advanced = [True] * len(self.fields)
        self.captures = 0
        """Steps captured (one per distinct ``dt`` and ``diag_fn``, each one
        graph, or one graph per card across cards; 0 on the CPU)."""
        self.capture_s = 0.0
        """Seconds of the last warm-up and capture."""
        self.reports: list = []
        """The solver reports of the last step (device scalars; on the card
        the graph's, which the next replay overwrites)."""

    def _device(self):
        return self.fields[0]._VAR.device

    def _lanes(self):
        """The lanes of a step's graphs: None where the model's placed solves
        and block state lie on one card (one graph), else
        ``dispatch.lanes_across`` of their placement (one graph per card;
        under the CPU tests' stand-in, ``per_card(blocks_as_cards=True)``, a
        lane per block). Raises ``NotImplementedError`` for placements on two
        sets of cards."""
        device = self._device()
        if device.type != "cuda" and per_card_mode() != "blocks":
            return None
        placed = [s.config["fdm"].get("decomp") for s in _solvers_of(self.model)
                  if s.config is not None and "fdm" in s.config]
        placed += [f._VAR.placement.decomp for f in self.fields
                   if isinstance(f._VAR, blocks.BlockTensor)]
        placed = [d for d in placed if d is not None and d.placed]
        # one card, or blocks on the host (the solve's own check raises)
        found = {lanes_across(device, d) for d in placed} - {None}
        if len(found) > 1:
            raise NotImplementedError(
                "FusedStepRunner: the model's solves are placed on different sets of cards "
                f"({sorted(tuple(map(str, ls)) for ls in found)}); a step's graphs are one per "
                "card of one placement")
        if not found:
            return None
        return found.pop()

    def _core_on(self, lanes, state, dt, t, diag_fn):
        """``_core`` on the step's ``lanes`` (``_lanes``): across cards in the
        per-card form, the diagnostics the lead card's replicas."""
        if not lanes:
            return self._core(state, dt, t, diag_fn)
        with per_card():
            new, diag, reports = self._core(state, dt, t, diag_fn)
        return new, _map(diag, blocks.lead_replica), reports

    # -- solver flags ----------------------------------------------------
    def _sync_off(self):
        """Force ``sync: False`` solves; returns the saved flags."""
        saved = []
        for s in _solvers_of(self.model):
            if s.config is not None and "fdm" in s.config:
                saved.append((s, s.config["fdm"].get("sync", None)))
                s.config["fdm"]["sync"] = False
        return saved

    @staticmethod
    def _sync_restore(saved) -> None:
        for s, flag in saved:
            if flag is None:
                s.config["fdm"].pop("sync", None)
            else:
                s.config["fdm"]["sync"] = flag

    def _break_aliases(self) -> None:
        """Eager init and stepping share tensors freely (``p._VARo`` and
        ``dp._VARo`` both hold the init-time zeros); in-place stepping needs
        each state slot to own its tensor. Copy the later duplicates."""
        seen: set[int] = set()
        for f in self.fields:
            for tag in ("_VAR", "_VARo", "_VARoo"):
                a = getattr(f, tag, None)
                if a is None:
                    continue
                if a.data_ptr() in seen:
                    setattr(f, tag, a.clone())
                else:
                    seen.add(a.data_ptr())

    # -- field state -----------------------------------------------------
    def _pack(self):
        return tuple((f._VAR, f._VARo, getattr(f, "_VARoo", None)) for f in self.fields)

    def _unpack(self, state, whole: bool = False) -> None:
        """Bind the fields to ``state``; ``whole``: a missing ``_VARoo`` is
        removed too (a first step's capture creates one)."""
        for f, (v, vo, voo) in zip(self.fields, state):
            f._VAR = v
            f._VARo = vo
            if voo is not None:
                f._VARoo = voo
            elif whole and "_VARoo" in vars(f):
                del f._VARoo

    def _save_host(self):
        return (self.model.t,
                [(f._t, f._dt, vars(f).get("_n_hist", _ABSENT)) for f in self.fields])

    def _restore_host(self, saved) -> None:
        t, per_field = saved
        self.model.t = t
        for f, (ft, fdt, nh) in zip(self.fields, per_field):
            f._t = ft
            f._dt = fdt
            if nh is _ABSENT:
                vars(f).pop("_n_hist", None)
            else:
                f._n_hist = nh

    # -- the per-step function -------------------------------------------
    def _core(self, state, dt, t, diag_fn=None):
        """``(state, dt, t) -> (state', diag, reports)``: the model's step
        on the swapped-in state, the model restored afterwards."""
        model = self.model
        saved_state = self._pack()
        saved_host = self._save_host()
        saved_attrs = dict(vars(model))
        n_hist0 = [f.n_hist for f in self.fields]
        try:
            self._unpack(state)
            model.t = t
            for f in self.fields:
                f._t = t
            with solve_log() as reports, whole_step():
                model.step(dt)
            self._hist_advanced = [f.n_hist > nh for f, nh in zip(self.fields, n_hist0)]
            self._t_advanced = [f._t is not t for f in self.fields]
            diag = diag_fn(model) if diag_fn is not None else None
            return self._pack(), diag, list(reports)
        finally:
            caches = {}
            if not capturing(self._device()):  # device constants built eagerly are kept
                caches = {k: vars(model)[k] for k in getattr(model, "_fused_caches", ())
                          if vars(model).get(k) is not None}
            self._unpack(saved_state, whole=True)
            self._restore_host(saved_host)
            vars(model).clear()
            vars(model).update(saved_attrs)
            vars(model).update(caches)
            for s in _solvers_of(model):
                s.report = None
                s.var = None
                s.eqs = None
                s.rhs = None

    # -- the card: capture and replay --------------------------------------
    def _program(self, dt: float, diag_fn):
        if self._compiled is None:
            self._compiled = OrderedDict()
        key = (float(dt), id(diag_fn) if diag_fn is not None else None)
        prog = self._compiled.get(key)
        if prog is None:
            prog = self._capture(dt, diag_fn)
            self._compiled[key] = prog
            while len(self._compiled) > self._PROGRAMS_MAX:
                self._compiled.popitem(last=False)
        self._compiled.move_to_end(key)
        return prog

    def _capture(self, dt, diag_fn) -> _Program:
        import time

        tic = time.perf_counter()
        device = self._device()
        state = self._pack()
        slots = [(i, lvl) for i, st in enumerate(state) for lvl in range(3) if st[lvl] is not None]
        n = len(slots)
        runner = self
        lanes = self._lanes()

        def fn(*inputs):
            st = [[None, None, None] for _ in self.fields]
            for (i, lvl), x in zip(slots, inputs[:n]):
                st[i][lvl] = x
            new, diag, reports = runner._core_on(lanes, tuple(tuple(s) for s in st), dt,
                                                 inputs[n], diag_fn)
            if capturing(device):
                # write the new state back into the static inputs, in an
                # order that reads each buffer before it is overwritten
                pending = {k: new[i][lvl] for k, (i, lvl) in enumerate(slots)
                           if new[i][lvl] is not inputs[k]}
                while pending:
                    ready = [k for k in pending
                             if not any(inputs[k] is src for src in pending.values())]
                    if not ready:  # a cycle: keep one buffer's old value aside
                        k = next(iter(pending))
                        old = inputs[k].clone()
                        pending = {j: old if src is inputs[k] else src
                                   for j, src in pending.items()}
                        continue
                    for k in ready:
                        inputs[k].copy_(pending.pop(k))
            return new, diag, reports

        t0 = torch.full((), float(self.model.t), dtype=torch.float64, device=device)
        inputs = [state[i][lvl] for i, lvl in slots] + [t0]
        call = GraphedCall(fn, device, lanes=lanes)
        attrs = dict(vars(self.model))
        call.warm(*inputs)
        call.capture(*inputs)
        self.captures += 1
        self.capture_s = time.perf_counter() - tic
        return _Program(call, slots, attrs)

    def _replay(self, prog: _Program):
        call = prog.call
        static = call.static_inputs
        state = self._pack()
        inputs = []
        for k, (i, lvl) in enumerate(prog.slots):
            x = state[i][lvl]
            if x is not static[k] and any(x is s for s in static):
                x = x.clone()  # another slot's buffer: read it before it is overwritten
            inputs.append(x)
        static[-1].fill_(float(self.model.t))
        new, diag, reports = call.replay(*inputs, static[-1])
        # the fields: the graph's buffers (donate) or copies of them; a slot
        # the graph has no buffer for (a first step's new _VARoo) is copied
        bound = [[None, None, None] for _ in self.fields]
        for k, (i, lvl) in enumerate(prog.slots):
            bound[i][lvl] = static[k] if self._donate else static[k].clone()
        for i, st in enumerate(new):
            for lvl in range(3):
                if bound[i][lvl] is None and st[lvl] is not None:
                    bound[i][lvl] = st[lvl].clone()
        self._unpack(tuple(tuple(b) for b in bound))
        return diag, reports

    # -- public ----------------------------------------------------------
    def _advance(self, dt: float, n: int) -> None:
        """Advance the host clocks the step could not, only for the fields
        the step advances (recorded by the core)."""
        self.model.t += dt * n
        for f, hist, tadv in zip(self.fields, self._hist_advanced, self._t_advanced):
            if tadv:
                f._t += dt * n
            if hist:
                f._dt = dt
                f._n_hist = f.n_hist + n

    def _step(self, dt: float, diag_fn=None):
        """One fused step; returns the step's diagnostics (on the card the
        graph's tensors, which the next replay overwrites)."""
        if self._donate:
            self._break_aliases()
        if self._device().type != "cuda":
            if self._compiled is None:
                self._compiled = OrderedDict()
            self._compiled.setdefault((float(dt), id(diag_fn) if diag_fn else None), None)
            t = torch.full((), float(self.model.t), dtype=torch.float64, device=self._device())
            lanes = self._lanes()
            new, diag, reports = GraphedCall(
                lambda: self._core_on(lanes, self._pack(), dt, t, diag_fn), self._device(),
                lanes=lanes)()  # on the CPU: the core itself, on the step's lanes
            self._unpack(new)
        else:
            diag, reports = self._replay(self._program(dt, diag_fn))
        self.reports = reports
        self._advance(dt, 1)
        return diag

    def step(self, dt: float) -> None:
        saved_sync = self._sync_off()
        try:
            self._step(dt)
        finally:
            self._sync_restore(saved_sync)

    def run(self, dt: float, n_steps: int) -> None:
        for _ in range(n_steps):
            self.step(dt)

    def run_batched(self, dt: float, n_steps: int, diag_fn=None):
        """``n_steps`` fused steps (one graph replay each), with optional
        per-step diagnostics ``diag_fn: model -> pytree of tensors``,
        evaluated on the post-step state inside the step (on the card inside
        the graph). Returns the stacked pytree (leading axis ``n_steps``)
        as device tensors — fetch once per run — or None without
        ``diag_fn``."""
        saved_sync = self._sync_off()
        diags = []
        try:
            for _ in range(int(n_steps)):
                d = self._step(dt, diag_fn)
                if diag_fn is not None:
                    diags.append(_map(d, torch.clone))
        finally:
            self._sync_restore(saved_sync)
        return _stack(diags) if diags else None
