"""Fused whole steps and captures across cards, in their per-card form, on
the CPU (float64).

Where a model's solves are placed over blocks on several cards, a fused
step is one CUDA graph per card (``FusedStepRunner`` with
``GraphedCall(..., lanes=...)``), its core run in the per-card form
(``graph_loop.per_card``): every scalar of a solve and every reduction of a
block vector replicated on each card and combined there in block order,
every move between cards an ``ops.peer`` put and wait; a placed solve in a
user's capture of one graph per card runs in the same form. The CPU has no
card and no graph, so the tests drive that form on ``("cpu",) * n``
placements with every block standing in for a card of its own
(``per_card(blocks_as_cards=True)``), as ``test_torch_placed_across.py``
does for the solves:

* the fused Smagorinsky ``PeriodicFlow`` LES of
  ``test_torch_placed_graphs.py`` (33^2 on (2, 2) blocks), its state whole
  or on the blocks (``put_state``), in the per-card form against its eager
  placed steps: the same bits of the state, its history and the viscosity,
  the same clocks and ``itr`` solve by solve; and against the JAX
  package's ``run(fused=True)`` with ``DomainDecomposition((2, 2))``
  (eager steps there, after its fallback): 1e-10;
* a user's ``GraphedCall(fn, ..., lanes=...)`` holding a placed CG and an
  MG-PCG ``sync: False`` solve: the ``sync: True`` solve's bits, ``itr`` and
  ``tol``;
* the same on (4, 2) blocks, eight stand-in cards;
* the runner's lanes: none for a placement on one card, the lead card then
  the other cards of the blocks for one across cards, on every placement
  and size, the state whole or on blocks.
"""
import warnings
from math import pi
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyapes_tpu_torch.models as pmodels  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.models.navier_stokes import smagorinsky_viscosity  # noqa: E402
from pyapes_tpu_torch.ops.graph_loop import GraphedCall, per_card  # noqa: E402
from pyapes_tpu_torch.parallel import DomainDecomposition, blocks  # noqa: E402
from pyapes_tpu_torch.solver.linalg import dispatch  # noqa: E402
from pyapes_tpu_torch.solver.ops import solve_log  # noqa: E402
from pyapes_tpu_torch.utils.fuse import FusedStepRunner  # noqa: E402
from test_torch_placed_across import _Combines, _solve  # noqa: E402
from test_torch_placed_graphs import LES_DT, LES_N, LES_NU, LES_STEPS, _jax_les  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401


def _placed(ms):
    return DomainDecomposition(ms, devices=("cpu",) * int(np.prod(ms)))


def _spy_check_placed(mp) -> list:
    """Record what every solve's ``dispatch._check_placed`` returns (True:
    the solve ran in its per-card form inside a call of one graph per
    card)."""
    seen = []
    real = dispatch._check_placed

    def spy(x0, decomp):
        seen.append(real(x0, decomp))
        return seen[-1]

    mp.setattr(dispatch, "_check_placed", spy)
    return seen


def _les(fused: bool, state: str, ms=(2, 2)):
    """The Smagorinsky Taylor-Green ``PeriodicFlow`` at 33^2 with its solves
    on placed ``ms`` blocks and its state ``state`` ("whole" or "blocks":
    ``put_state``), ``LES_STEPS`` steps: fused in the per-card form (a
    replica per block), or eager in the lead-combine form; two through
    ``run``, the rest one by one, the viscosity then refreshed as ``run``
    does. ``(model, itr per solve of the steps after the first two,
    warnings, what each solve's ``_check_placed`` returned)``."""
    L = 2 * pi
    dd = _placed(ms)
    mesh = Mesh(Box[0:L, 0:L], None, [LES_N] * 2, device="cpu", dtype="double")
    m = pmodels.PeriodicFlow(mesh, nu=LES_NU, config={"decomp": dd},
                             mu_strain_fn=smagorinsky_viscosity(LES_NU, mesh, cs=0.17))
    X, Y = mesh.grid
    m.set_velocity(torch.sin(X) * torch.cos(Y), -torch.cos(X) * torch.sin(Y))
    if state == "blocks":
        m.put_state(dd)
    itr = []
    with warnings.catch_warnings(record=True) as w, pytest.MonkeyPatch.context() as mp:
        warnings.simplefilter("always")
        placed = _spy_check_placed(mp)
        if fused:
            with per_card(blocks_as_cards=True):
                m.run(LES_DT, 2, fused=True)
                for _ in range(LES_STEPS - 2):
                    m.fused_runner().step(LES_DT)
                    itr += [int(r["itr"]) for r in m.fused_runner().reports]
                m._refresh_strain_viscosity()
        else:
            m.run(LES_DT, 2)
            for _ in range(LES_STEPS - 2):
                with solve_log() as reports:
                    m.step(LES_DT)
                itr += [int(r["itr"]) for r in reports]
            m._refresh_strain_viscosity()
    return m, itr, [str(x.message) for x in w], placed


@pytest.fixture(scope="module")
def les_runs():
    return {(fused, state): _les(fused, state) for fused in (True, False)
            for state in ("whole", "blocks")}


@pytest.mark.parametrize("state", ["whole", "blocks"])
def test_fused_per_card_les_equals_eager_steps(les_runs, state):
    """The fused LES in the per-card form against the eager placed steps of
    the same state layout: no warning; ``itr`` solve by solve; the bits of
    every state Field's value and history, its ``n_hist`` and clocks, and
    the viscosity field; the state stays in its layout."""
    (mf, itr_f, warn_f, placed_f), (me, itr_e, _, placed_e) = (les_runs[(True, state)],
                                                                les_runs[(False, state)])
    assert warn_f == []
    # the fused step's solves ran on its lanes (a lane per block), the eager ones not
    assert placed_f and all(p is True for p in placed_f)
    assert placed_e and not any(placed_e)
    assert itr_f == itr_e and len(itr_e) == 3 * (LES_STEPS - 2)
    for a, b in zip(mf.state_fields(), me.state_fields()):
        assert isinstance(a(), blocks.BlockTensor) == (state == "blocks"), a.name
        assert torch.equal(a().cpu(), b().cpu()) and torch.equal(a._VARo.cpu(), b._VARo.cpu())
        assert a.n_hist == b.n_hist and a._t == b._t and a._dt == b._dt, a.name
    assert torch.equal(mf._nu_field.cpu(), me._nu_field.cpu())
    assert mf.t == me.t


@pytest.mark.parametrize("state", ["whole", "blocks"])
def test_fused_per_card_les_on_eight_blocks_equals_eager_steps(state):
    """The fused LES on placed (4, 2) blocks (eight stand-in cards, the
    block count of the card runs' (4, 2, 1) placements), its state whole or
    on the blocks, in the per-card form against its eager placed steps: no
    warning, ``itr`` solve by solve, the bits of every state Field's value
    and history and of the viscosity field."""
    (mf, itr_f, warn_f, placed_f), (me, itr_e, _, _) = (_les(True, state, (4, 2)),
                                                        _les(False, state, (4, 2)))
    assert warn_f == [] and placed_f and all(p is True for p in placed_f)
    assert itr_f == itr_e and len(itr_e) == 3 * (LES_STEPS - 2)
    for a, b in zip(mf.state_fields(), me.state_fields()):
        assert isinstance(a(), blocks.BlockTensor) == (state == "blocks"), a.name
        assert torch.equal(a().cpu(), b().cpu()) and torch.equal(a._VARo.cpu(), b._VARo.cpu())
    assert torch.equal(mf._nu_field.cpu(), me._nu_field.cpu())


@pytest.mark.parametrize("state", ["whole", "blocks"])
def test_fused_per_card_les_matches_jax(les_runs, state):
    """The per-card fused LES against the JAX package's fused run with
    ``DomainDecomposition((2, 2))`` (eager steps there, after its fallback):
    1e-10."""
    mf = les_runs[(True, state)][0]
    jm, _ = _jax_les()
    for a, b in zip(mf.state_fields(), jm.state_fields()):
        np.testing.assert_allclose(a().cpu().numpy(), np.asarray(b()), atol=1e-10, rtol=0,
                                   err_msg=a.name)


def test_fused_per_card_step_combines_on_every_holder(monkeypatch):
    """A fused step of the LES with its state on blocks, in the per-card
    form, combines its sums on every holder (``_combine_everywhere``) and
    gathers no block vector."""
    L = 2 * pi
    dd = _placed((2, 2))
    mesh = Mesh(Box[0:L, 0:L], None, [LES_N] * 2, device="cpu", dtype="double")
    m = pmodels.PeriodicFlow(mesh, nu=LES_NU, config={"decomp": dd},
                             mu_strain_fn=smagorinsky_viscosity(LES_NU, mesh, cs=0.17))
    X, Y = mesh.grid
    m.set_velocity(torch.sin(X) * torch.cos(Y), -torch.cos(X) * torch.sin(Y))
    m.put_state(dd)
    with per_card(blocks_as_cards=True):
        m.run(LES_DT, 2, fused=True)
        combines = _Combines(monkeypatch)
        g0 = blocks.gathers
        m.fused_runner().step(LES_DT)
    assert combines.n > 0 and blocks.gathers == g0
    assert all(isinstance(r["itr"], torch.Tensor) and r["itr"].dim() == 0
               and not isinstance(r["itr"], blocks.Replicated)
               for r in m.fused_runner().reports)


@pytest.mark.parametrize("kind", ["cg", "mg", "mg_bench"])
def test_lanes_capture_of_a_placed_solve_equals_sync_true(kind, monkeypatch):
    """A user's call of one graph per card (``GraphedCall(fn, "cpu",
    lanes=blocks.card_lanes(dd, "cpu"))``: on the CPU it calls ``fn`` on its
    lanes, a lane per block under the stand-in) holding a placed ``sync:
    False`` CG, MG-PCG or bench's bf16 V(2,2) FMG MG-PCG solve: the solve
    takes its per-card form inside the call (``_check_placed``), and gives
    the ``sync: True`` solve's ``itr``, ``tol`` and solution bits, a Field on
    blocks and a whole Field. The same solve in a call of one graph (no
    lanes) raises, naming A11f."""
    dd = DomainDecomposition((2, 2, 2), devices=("cpu",) * 8)
    for field in ("blocks", "whole"):
        ref, rref = _solve(kind, field, True)
        combines = _Combines(monkeypatch)
        with per_card(blocks_as_cards=True):
            lanes = blocks.card_lanes(dd, "cpu")
            placed = _spy_check_placed(monkeypatch)
            out, rep = GraphedCall(lambda: _solve(kind, field, False), "cpu", lanes=lanes)()
            assert placed == [True]
            with pytest.raises(NotImplementedError, match="A11f") as e:
                GraphedCall(lambda: _solve(kind, field, False), "cpu")()
            assert "capture of one graph" in str(e.value)
        assert combines.n > 0 and rref["itr"] >= 1
        assert int(rep["itr"]) == rref["itr"] and float(rep["tol"]) == rref["tol"]
        assert len(out) == len(ref) and all(torch.equal(a, b) for a, b in zip(out, ref))


def test_graph_lanes_of_the_call_underway(monkeypatch):
    """``graph_loop.graph_lanes``: None outside every ``GraphedCall``; a
    call's lanes in its eager warm-up (so a placed solve there takes the
    per-card form its capture records) and in its call on the CPU, nested
    calls the innermost's."""
    from pyapes_tpu_torch.ops import graph_loop

    cpu = torch.device("cpu")
    seen = []
    inner = GraphedCall(lambda: seen.append(graph_loop.graph_lanes()), "cpu", lanes=(cpu,) * 2)

    def outer_fn():
        seen.append(graph_loop.graph_lanes())
        inner()
        seen.append(graph_loop.graph_lanes())
        seen.append(graph_loop.use_host_loops())

    outer = GraphedCall(outer_fn, "cuda:0", lanes=("cuda:0", "cuda:1", "cuda:2"))
    outer.warm()
    cards = tuple(torch.device(f"cuda:{i}") for i in range(3))
    assert seen == [cards, (cpu, cpu), cards, True]
    assert graph_loop.graph_lanes() is None
    seen.clear()
    GraphedCall(lambda: seen.append(graph_loop.graph_lanes()), "cpu")()
    assert seen == [(cpu,)] and graph_loop.graph_lanes() is None


def test_runner_lanes_follow_the_placement(monkeypatch):
    """``FusedStepRunner._lanes``: None on the CPU and for a placement on one
    card; across cards the lead card, then the other cards of the blocks in
    block order (``blocks.card_lanes``); under the CPU stand-in a lane per
    block. Two placements on different sets of cards raise. Every other
    placement returns its lanes, at any size, the state whole or on the
    blocks: two, three and four cards with two, three and four blocks on
    each, at 17^3 and 257^3 (graphs per card that segfaulted at their
    first launch there, launched one after another from one thread, run
    with each card's launch on a thread of its own)."""
    import pyapes_tpu_torch.utils.fuse as fuse

    cuda = [torch.device(f"cuda:{i}") for i in range(4)]

    def dd(*devs):
        return SimpleNamespace(placed=True, devices=tuple(devs))

    def lanes(*decomps, device=cuda[0], state=None, n=17):
        solvers = [SimpleNamespace(config={"fdm": {"decomp": d}}) for d in decomps]
        monkeypatch.setattr(fuse, "_solvers_of", lambda model: solvers)
        r = FusedStepRunner.__new__(FusedStepRunner)
        r.model = None
        r.fields = [SimpleNamespace(_VAR=state if state is not None
                                    else torch.empty((3, n, n, n), device="meta"))]
        r._device = lambda: device
        return r._lanes()

    def on_blocks(dd, n=17):  # a block state on dd's devices (the parts stand in)
        lay = SimpleNamespace(devices=dd.devices, lead=torch.device("cpu"), decomp=dd)
        return blocks.BlockTensor([torch.zeros(1, 2)] * len(dd.devices), lay, (3, n, n, n))

    assert lanes(dd(cuda[0], cuda[1]), device=torch.device("cpu")) is None
    assert lanes(dd(cuda[0], cuda[0], cuda[0])) is None
    assert lanes(dd(cuda[0], torch.device("cpu"))) is None  # the solve's own check raises
    assert lanes(None, dd(cuda[1], cuda[0], cuda[1], cuda[2])) == tuple(cuda[:3])
    assert lanes(dd(cuda[1], cuda[0]), dd(cuda[0], cuda[1])) == (cuda[0], cuda[1])
    assert blocks.card_lanes(dd(cuda[2], cuda[1]), cuda[0]) == (cuda[0], cuda[2], cuda[1])
    with pytest.raises(NotImplementedError, match="different sets of cards"):
        lanes(dd(cuda[0], cuda[1]), dd(cuda[0], cuda[2]))
    with per_card(blocks_as_cards=True):  # the stand-in: a lane per block
        cpu = dd(*("cpu",) * 4)
        assert lanes(cpu, device=torch.device("cpu"), state=on_blocks(cpu)) == (
            torch.device("cpu"),) * 4
    for n_cards, n_blocks in ((4, 8), (2, 8), (2, 4), (3, 6), (4, 4)):
        d = dd(*(cuda[i % n_cards] for i in range(n_blocks)))
        for n in (17, 257):
            assert lanes(d, n=n) == tuple(cuda[:n_cards])
            assert lanes(d, state=on_blocks(d, n)) == tuple(cuda[:n_cards])
