"""``sync: False`` solves across cards, in their per-card form, on the CPU
(float64).

Across cards a placed ``sync: False`` solve is one CUDA graph per card:
each card's loop ends on its own replica of the loop's exit, every sum is
combined on every card in block order, and every move between cards is
an ``ops.peer`` put and wait (``graph_loop.per_card``,
``blocks.Replicated``, ``blocks.copy_into``). The CPU has no card and no
graph, so the tests drive that form on ``("cpu",) * n`` placements with
every block standing in for a card of its own
(``per_card(blocks_as_cards=True)``: a replica per block, the plain put
and wait between them):

* against the lead-combine path (``sync: True``): the same ``itr``, ``tol``
  and solution bits for CG, BiCGSTAB, MG-PCG (an f32 cycle and bench's bf16
  V(2,2) FMG cycle), fastdiag, CG + FD, Darcy's variable-Γ Laplacian and an
  upwind Div, a Field on blocks and a whole Field, and CG with a Dirichlet
  and a Neumann (flux) immersed body;
* a sum, a max and the per-component 2-norm combined on every holder: each
  replica bit-equal to ``_reduce``'s lead combine (f32 data, where the
  order shows);
* against the JAX package's decomposed ``sync: False`` solve on the 8
  virtual CPU devices (``DomainDecomposition((2, 4))``): the same ``itr``,
  1e-12;
* a copy between two devices inside a capture of one graph per card
  raises, naming its call site (the dispatch-mode check, with the CPU and
  the meta device standing in for two cards); the plain put and wait;
* bench's MG-PCG (bf16 V(2,2), FMG and not) on the (2, 2, 1) and (4, 2, 1)
  placements of the card matrix, in the per-card form: the ``sync: True``
  bits;
* a replay's lanes launch side by side, each from a thread of its own.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops import graph_loop, peer  # noqa: E402
from pyapes_tpu_torch.ops.graph_loop import CrossCardCopy, per_card  # noqa: E402
from pyapes_tpu_torch.parallel import DomainDecomposition, blocks  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables import bcs as pbcs  # noqa: E402
from test_torch_decomp import JAX, PLACED  # noqa: E402
from test_torch_placed_graphs import _poisson64  # noqa: E402
from test_torch_placed_options import CG as OPT_CG  # noqa: E402
from test_torch_placed_options import PLACED as OPT_PLACED  # noqa: E402
from test_torch_placed_options import SQUARE, U2, hot  # noqa: E402
from test_torch_placed_options import _solve as _opt_solve  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401


def _placed(ms):
    return DomainDecomposition(ms, devices=("cpu",) * int(np.prod(ms)))


NX = (16, 16, 16)
CASES = {
    "cg": {"method": "cg", "tol": 1e-10, "max_it": 200},
    "bicgstab": {"method": "bicgstab", "tol": 1e-10, "max_it": 200},
    "mg": {"method": "cg", "tol": 1e-10, "max_it": 200, "precond": "mg"},
    "fastdiag": {"method": "fastdiag", "tol": 1e-10, "max_it": 50},
    "cg_fd": {"method": "cg", "tol": 1e-10, "max_it": 100, "precond": "fd"},
    "darcy": {"method": "cg", "tol": 1e-10, "max_it": 200, "precond": "mg"},
    "upwind": {"method": "bicgstab", "tol": 1e-10, "max_it": 400},
    # bench's cycle: bf16 V(2,2), omega 0.857, FMG
    "mg_bench": {"method": "cg", "tol": 1e-8, "max_it": 200, "precond": "mg",
                 "mg_opts": {"dtype": "bfloat16", "n_pre": 2, "n_post": 2, "omega": 0.857,
                             "fmg": True}},
}


class _Combines:
    """Counts ``blocks._combine_everywhere`` calls (the per-card sums)."""

    def __init__(self, monkeypatch):
        self.n = 0
        orig = blocks._combine_everywhere

        def counted(*a, **k):
            self.n += 1
            return orig(*a, **k)

        monkeypatch.setattr(blocks, "_combine_everywhere", counted)


def _solve(kind, field, sync, ms=(2, 2, 2), mg_opts=None):
    """``kind``'s solve on placed ``ms`` blocks at ``sync``: the Laplacian
    (CG, BiCGSTAB, MG-PCG, fastdiag, CG + FD), Darcy's variable-Γ Laplacian
    (Γ = 1 + x + 2 y z) or an upwind Div minus the Laplacian (a seeded
    random velocity), homogeneous Dirichlet faces, a seeded random RHS;
    ``field`` "blocks": the Field, the RHS, Γ and the velocity on the
    blocks; ``mg_opts`` replaces the case's multigrid options. ``(the
    solution's blocks or whole tensor, the report)``."""
    dd = _placed(ms)

    def put(t):
        return blocks.put(t, dd) if field == "blocks" else t

    mesh = Mesh(Box[0:1, 0:1, 0:1], None, list(NX), device="cpu", dtype="double")
    var = Field("p", 1, mesh, {"domain": pbcs.homogeneous_bcs(3, 0.0, "dirichlet"),
                               "obstacle": None}, init_val=0.0)
    var.VAR = put(var())
    rng = np.random.default_rng(4)
    rhs = put(torch.from_numpy(rng.standard_normal((1, *NX))))
    fdm = FDM({"div": {"limiter": "upwind", "edge": False}})
    if kind == "darcy":
        X, Y, Z = (g.numpy() for g in mesh.grid)
        g = torch.from_numpy(1.0 + X + 2.0 * Y * Z)
        lhs = fdm.laplacian(put(g[None]) if field == "blocks" else g, var)
    elif kind == "upwind":
        lhs = fdm.div(put(torch.from_numpy(rng.standard_normal((1, *NX)))), var) \
            - fdm.laplacian(1.0, var)
    else:
        lhs = fdm.laplacian(1.0, var)
    cfg = dict(CASES[kind])
    if mg_opts is not None:
        cfg["mg_opts"] = mg_opts
    s = Solver({"fdm": {"criterion": "residual", "report": False, "sync": sync, "decomp": dd,
                        **cfg}})
    s.set_eq(lhs == rhs)
    rep = s.solve()
    x = var()
    assert isinstance(x, blocks.BlockTensor) == (field == "blocks")
    return (list(x.parts) if field == "blocks" else [x]), rep


@pytest.mark.parametrize("field", ["blocks", "whole"])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_per_card_solve_equals_lead_combine(kind, field, monkeypatch):
    """The per-card form at ``sync: False`` (a replica per block, every sum
    on every holder, the plain put and wait) against the lead-combine
    ``sync: True`` solve: the same ``itr``, ``tol`` bits and solution bits;
    the report's scalars are the lead's replicas, 0-d tensors."""
    ref, rref = _solve(kind, field, True)
    combines = _Combines(monkeypatch)
    with per_card(blocks_as_cards=True):
        out, rep = _solve(kind, field, False)
    assert combines.n > 0  # the per-card sums ran
    assert rref["itr"] >= 1
    for k in ("itr", "tol"):
        assert type(rep[k]) is torch.Tensor and rep[k].dim() == 0
    assert int(rep["itr"]) == rref["itr"] and float(rep["tol"]) == rref["tol"]
    assert len(out) == len(ref) and all(torch.equal(a, b) for a, b in zip(out, ref))


def _heated(cfg, n=32):
    """A Neumann body with flux 5 in the unit square on placed (2, 4)
    blocks (the shells read sources across the blocks), CG."""
    P = OPT_PLACED
    mesh = P.Mesh(P.Box[U2], [P.Box[SQUARE]], [n, n])
    var = P.Field("p", 1, mesh, {"domain": P.bcs.homogeneous_bcs(2, 0.0, "dirichlet"),
                                 "obstacle": [{"bc_type": "neumann", "bc_val": 5.0}]})
    return _opt_solve(P, (2, 4), var, P.FDM().laplacian(1.0, var),
                      P.arr(np.zeros((1, n, n))), cfg)


@pytest.mark.parametrize("body", ["dirichlet", "neumann"])
def test_per_card_obstacle_solve_equals_lead_combine(body, monkeypatch):
    """Immersed obstacles in the per-card form: a Dirichlet body on placed
    (4, 2) blocks and a Neumann body with flux on (2, 4) blocks, CG at
    ``sync: False`` against the lead-combine ``sync: True`` solve: the
    same ``itr``, ``tol`` bits and solution bits."""
    def run(cfg):
        return hot(OPT_PLACED, (4, 2), cfg) if body == "dirichlet" else _heated(cfg)

    ref, rref = run(OPT_CG)
    combines = _Combines(monkeypatch)
    with per_card(blocks_as_cards=True):
        out, rep = run({**OPT_CG, "sync": False})
    assert combines.n > 0 and rref["converge"]
    assert int(rep["itr"]) == rref["itr"] and float(rep["tol"]) == rref["tol"]
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("reduction", ["sum", "max", "l2_per_dim", "mean"])
def test_combine_on_every_holder_equals_reduce(reduction):
    """A reduction of a block vector combined on each of the 8 holders
    (``_combine_everywhere``: each holder's stacked partials put on every
    other, folded in block order) gives every replica the bits of
    ``_reduce``'s combine on the lead device; f32 data, a 3-component
    vector, so a change of order would show."""
    dd = _placed((2, 4))
    x = blocks.put(torch.from_numpy(
        np.random.default_rng(2).standard_normal((3, 64, 64)).astype(np.float32) * 1e3), dd)

    def red(v):
        if reduction == "sum":
            return v.sum(dim=(1, 2), keepdim=True)
        if reduction == "max":
            return v.max()
        if reduction == "mean":
            return v.mean()
        return blocks.l2_per_dim(v)

    ref = red(x)
    with per_card(blocks_as_cards=True):
        rep = red(x)
    assert isinstance(rep, blocks.Replicated) and len(rep.parts) == 8
    assert type(ref) is torch.Tensor
    assert all(torch.equal(p, ref) for p in rep.parts)


def test_replicated_scalars_follow_their_holders():
    """Replicated scalars: an operation runs on every replica; with block
    vectors each block takes its holder's replica; a host read takes the
    lead's; ``lead_replica`` gives it back as a plain tensor."""
    dd = _placed((2, 2))
    x = blocks.put(torch.arange(16.0, dtype=torch.float64).reshape(1, 4, 4), dd)
    with per_card(blocks_as_cards=True):
        cs = blocks.cards(x.placement)
        a = blocks.Replicated([torch.tensor(float(i + 1), dtype=torch.float64)
                               for i in range(4)], cs)
        b = a * 2 + 1
        y = x * a  # block i scaled by its holder's replica i + 1
        assert isinstance(b, blocks.Replicated)
        assert [float(p) for p in b.parts] == [3.0, 5.0, 7.0, 9.0]
        assert float(b) == 3.0
        assert type(blocks.lead_replica(b)) is torch.Tensor
        for i, p in enumerate(y.parts):
            assert torch.equal(p, x.parts[i] * (i + 1))


@pytest.mark.parametrize("method", ["mg", "mg_fmg", "fastdiag"])
def test_per_card_sync_false_vs_jax(method, monkeypatch):
    """JAX ``sync: False`` with ``DomainDecomposition((2, 4))`` on 8 virtual
    CPU devices against the port's per-card form on ``("cpu",) * 8``
    (the Field on blocks): the same ``itr``, the solutions within 1e-12."""
    jvar, jrep = _poisson64(JAX, (2, 4), method)
    combines = _Combines(monkeypatch)
    with per_card(blocks_as_cards=True):
        var, rep = _poisson64(PLACED, (2, 4), method, on_blocks=True)
    assert combines.n > 0
    assert isinstance(jrep["itr"], jax.Array)
    assert int(rep["itr"]) == int(jrep["itr"]) >= 1
    np.testing.assert_allclose(var().numpy(), np.asarray(jvar()), atol=1e-12, rtol=0)


def test_cross_device_copy_in_a_per_card_capture_raises_naming_its_site():
    """The check a capture of one graph per card keeps on: a ``.to`` of
    another device and a ``copy_`` from one raise ``CrossCardCopy`` naming
    this file and line (the CPU and the meta device standing in for two
    cards); a copy on one device, and the block-wise work of a block vector
    whose blocks share a device, pass."""
    x = torch.arange(6.0)
    meta = torch.empty(6, device="meta")
    dd = _placed((2, 1))
    v = blocks.put(torch.ones(1, 4, 4), dd)
    with graph_loop.cross_device_copies():
        y = x.to("cpu").clone()
        z = (v * 2.0).sum()
        with pytest.raises(CrossCardCopy, match=r"test_torch_placed_across\.py:\d+") as e:
            x.to("meta")
        assert "cpu to meta" in str(e.value)
        with pytest.raises(CrossCardCopy, match=r"test_torch_placed_across\.py:\d+"):
            meta.copy_(x)
    assert torch.equal(y, x) and float(z) == 32.0


# bench's cycle (bf16 V(2,2), omega 0.857) with and without its FMG start
BENCH_CYCLE = {"dtype": "bfloat16", "n_pre": 2, "n_post": 2, "omega": 0.857}


@pytest.mark.parametrize("field", ["blocks", "whole"])
@pytest.mark.parametrize("fmg", [False, True])
@pytest.mark.parametrize("ms", [(2, 2, 1), (4, 2, 1)])
def test_mg_cycle_across_cards_equals_sync_true(ms, fmg, field, monkeypatch):
    """Bench's MG-PCG across cards in its per-card form on the placements
    of the card matrix (``scripts/mg_across_matrix_torch.py``: (2, 2, 1)
    and (4, 2, 1), here four and eight stand-in cards, a block each), with
    and without the FMG start, a Field on blocks and a whole one: the
    ``sync: True`` solve's ``itr``, ``tol`` bits and solution bits. No
    placement or size is refused any more."""
    opts = {**BENCH_CYCLE, "fmg": fmg}
    ref, rref = _solve("mg", field, True, ms, opts)
    combines = _Combines(monkeypatch)
    with per_card(blocks_as_cards=True):
        out, rep = _solve("mg", field, False, ms, opts)
    assert combines.n > 0 and rref["converge"] and rref["itr"] >= 1
    assert int(rep["itr"]) == rref["itr"] and float(rep["tol"]) == rref["tol"]
    assert len(out) == len(ref) and all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("lanes", [2, 4])
def test_lanes_launch_side_by_side(lanes):
    """``graph_loop._launch_lanes`` launches every lane's graph from a thread
    of its own and returns once each launch has returned: a lane's launch
    that cannot return before every other lane's launch has begun (a
    barrier standing in for a card that waits for a put of a lane not
    launched yet) completes, where one thread launching the lanes one
    after another would wait forever (the barrier's timeout breaks it).
    A launch's error reaches the caller."""
    import threading

    barrier = threading.Barrier(lanes)

    class Graph:
        def replay(self):
            self.thread = threading.current_thread()
            barrier.wait(timeout=10)

    graphs = [Graph() for _ in range(lanes)]
    graph_loop._launch_lanes(graphs, [None] * lanes)
    assert len({g.thread for g in graphs}) == lanes
    assert threading.current_thread() not in {g.thread for g in graphs}

    class Failing:
        def replay(self):
            raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        graph_loop._launch_lanes([Failing()] * lanes, [None] * lanes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_peer_plain_put_and_wait(dtype):
    """On the CPU ``peer_put`` is ``dst.copy_(src)`` (strided faces into the
    slots of a halo-extended buffer, the rest untouched) and ``peer_wait``
    does nothing; a channel outside a capture has zeroed counters; a put
    of another shape raises."""
    src = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 5, 6, 7))).to(dtype)
    for j in range(3):
        buf = torch.zeros((2, *(n + 2 * (k == j) for k, n in enumerate((5, 6, 7)))), dtype=dtype)
        face = src.narrow(1 + j, 0, 1)
        slot = buf.narrow(1 + j, 0, 1).narrow(1 + (j + 1) % 3, 0, (5, 6, 7)[(j + 1) % 3])
        slot = slot.narrow(1 + (j + 2) % 3, 0, (5, 6, 7)[(j + 2) % 3])
        before = buf.clone()
        peer.peer_put(face, slot)
        peer.peer_wait(None, "cpu")
        assert torch.equal(slot, face)
        assert float(buf.sum() - before.sum()) == pytest.approx(float(face.double().sum()),
                                                                rel=1e-2)
    ch = peer.Channel.make("cpu", "cpu")
    assert ch.src.tolist() == [0, 0, 0] and ch.dst.tolist() == [0, 0]
    with pytest.raises(ValueError):
        peer.peer_put(src, torch.zeros(3, dtype=dtype))
