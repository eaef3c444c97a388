"""Placed ``sync: False`` solves and fused whole steps on the CPU (float64).

A placed decomposition (``devices=("cpu",) * n``: each block its own
allocation) now takes ``sync: False``, a capture and a fused whole step.
On the card a ``sync: False`` solve is one CUDA graph of the solve and a
fused step one graph of the step (``tests/test_torch_cuda.py``); on the
CPU both run the same loop bodies with no capture (the plain version), so
here they are held to the ``sync: True`` solves and the eager steps bit for
bit, and to the JAX package:

* a ``sync: False`` solve with ``DomainDecomposition((2, 4))`` on the 8
  virtual CPU devices (64^2, CG + MG and fastdiag) against the port's
  placed ``sync: False`` solve: the same ``itr``, 1e-12; the JAX solution
  stays sharded, as the port's Field on blocks stays on its blocks;
* placed ``sync: False`` against placed ``sync: True`` (fastdiag, CG + MG,
  BiCGSTAB + FD, Darcy's variable-Γ, upwind Div; a Field on blocks and a
  whole Field): the same bits, a 0-d tensor report, no block vector read
  on the host;
* a fused Smagorinsky ``PeriodicFlow`` on placed (2, 2) blocks against its
  eager steps (bits, no warning) and against the JAX package's
  ``run(fused=True)`` with the decomposition (1e-10), which falls back to
  eager steps there: the JAX fused step under a decomposition fails its
  trace at the host-side separability probe (``linalg.py:725`` ->
  ``fastdiag.py:72``: ``np.asarray`` of an axis vector that
  ``_commit_to_decomp`` made a tracer), a reference fault the port does not
  copy (its probe reads the host copies, ``axis_np``), pinned here.
"""
import warnings
from math import pi
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyapes_tpu.models as jmodels  # noqa: E402
from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.models.navier_stokes import smagorinsky_viscosity as jsmag  # noqa: E402
from pyapes_tpu.parallel import DomainDecomposition as JDD  # noqa: E402
import pyapes_tpu_torch.models as pmodels  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.models.navier_stokes import smagorinsky_viscosity  # noqa: E402
from pyapes_tpu_torch.ops.graph_loop import whole_step  # noqa: E402
from pyapes_tpu_torch.parallel import DomainDecomposition, blocks  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.solver.linalg import dispatch  # noqa: E402
from pyapes_tpu_torch.solver.ops import solve_log  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables import bcs as pbcs  # noqa: E402
from test_torch_decomp import JAX, PLACED, U2  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

CPU = torch.device("cpu")


def _placed(ms):
    return DomainDecomposition(ms, devices=("cpu",) * int(np.prod(ms)))


# -- the port against the JAX package: sync: False with a decomposition --------

JAX_CFGS = {"mg": {"method": "cg", "tol": 1e-8, "max_it": 500, "precond": "mg"},
            # bench's cycle in f64: V(2,2), omega 0.857, the FMG start
            "mg_fmg": {"method": "cg", "tol": 1e-8, "max_it": 500, "precond": "mg",
                       "mg_opts": {"n_pre": 2, "n_post": 2, "omega": 0.857, "fmg": True}},
            "fastdiag": {"method": "fastdiag", "tol": 1e-10, "max_it": 50}}


def _poisson64(P, ms, method, on_blocks=False):
    """A 64^2 Poisson solve (homogeneous Dirichlet faces, a seeded random
    RHS) at ``sync: False`` with the decomposition ``ms``; ``on_blocks``
    (the port): the Field and the RHS on the blocks. ``(var, report)``."""
    mesh = P.Mesh(P.Box[U2], [64, 64])
    var = P.Field("p", 1, mesh, {"domain": P.bcs.homogeneous_bcs(2, 0.0, "dirichlet"),
                                 "obstacle": None}, init_val=0.0)
    rhs = P.arr(np.random.default_rng(0).standard_normal((1, 64, 64)))
    dd = P.DD(ms)
    if on_blocks:
        var.VAR = blocks.put(var(), dd)
        rhs = blocks.put(rhs, dd)
    s = P.Solver({"fdm": {"criterion": "residual", "report": False, "sync": False,
                          "decomp": dd, **JAX_CFGS[method]}})
    s.set_eq(P.FDM().laplacian(1.0, var) == rhs)
    return var, s.solve()


@pytest.mark.parametrize("field", ["whole", "blocks"])
@pytest.mark.parametrize("method", sorted(JAX_CFGS))
def test_sync_false_decomposed_solve_vs_jax(method, field):
    """JAX ``sync: False`` with ``DomainDecomposition((2, 4))`` on 8 virtual
    CPU devices against the port's placed ``sync: False`` on ``("cpu",) *
    8``: both reports' ``itr`` device scalars, the same count, the
    solutions within 1e-12; JAX's solution stays sharded over the blocks
    (``PartitionSpec(None, 'sx', 'sy')``), the port's Field on blocks keeps
    its block vector and a whole Field gets its solution back whole."""
    jvar, jrep = _poisson64(JAX, (2, 4), method)
    var, rep = _poisson64(PLACED, (2, 4), method, on_blocks=field == "blocks")
    assert isinstance(jrep["itr"], jax.Array) and jrep["itr"].ndim == 0
    assert isinstance(rep["itr"], torch.Tensor) and rep["itr"].dim() == 0
    assert isinstance(rep["tol"], torch.Tensor) and rep["tol"].dim() == 0
    assert int(rep["itr"]) == int(jrep["itr"]) >= 1
    assert jvar().sharding.spec == jax.sharding.PartitionSpec(None, "sx", "sy")
    assert isinstance(var(), blocks.BlockTensor) == (field == "blocks")
    np.testing.assert_allclose(var().numpy(), np.asarray(jvar()), atol=1e-12, rtol=0)


# -- placed sync: False against placed sync: True ------------------------------

NX = (16, 16, 16)
CASES = {
    "fastdiag": {"method": "fastdiag", "tol": 1e-10, "max_it": 50},
    "mg": {"method": "cg", "tol": 1e-10, "max_it": 200, "precond": "mg"},
    "bicgstab_fd": {"method": "bicgstab", "tol": 1e-10, "max_it": 100, "precond": "fd"},
    "darcy": {"method": "cg", "tol": 1e-10, "max_it": 200, "precond": "mg"},
    "upwind": {"method": "bicgstab", "tol": 1e-10, "max_it": 400},
}


def _placed_solve(kind, field, sync):
    """``kind``'s solve on placed (2, 2, 2) blocks at ``sync``: the Laplacian
    (fastdiag, CG + MG, BiCGSTAB + FD), Darcy's variable-Γ Laplacian (Γ =
    1 + x + 2 y z) or an upwind Div minus the Laplacian (a seeded random
    velocity), homogeneous Dirichlet faces, a seeded random RHS; ``field``
    "blocks": the Field, the RHS, Γ and the velocity on the blocks.
    ``(the solution's blocks or whole tensor, the report, host gathers)``."""
    dd = _placed((2, 2, 2))

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
    s = Solver({"fdm": {"criterion": "residual", "report": False, "sync": sync, "decomp": dd,
                        **CASES[kind]}})
    s.set_eq(lhs == rhs)
    h0 = blocks.host_gathers
    rep = s.solve()
    x = var()
    assert isinstance(x, blocks.BlockTensor) == (field == "blocks")
    return (list(x.parts) if field == "blocks" else [x]), rep, blocks.host_gathers - h0


@pytest.mark.parametrize("field", ["blocks", "whole"])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_placed_sync_false_equals_sync_true(kind, field):
    """The same bits and ``itr``; ``sync: False`` reports ``itr`` and ``tol``
    as 0-d tensors and reads no block vector on the host."""
    ref, rref, _ = _placed_solve(kind, field, True)
    out, rep, host = _placed_solve(kind, field, False)
    assert rref["converge"] and rref["itr"] >= 1
    for k in ("itr", "tol"):
        assert isinstance(rep[k], torch.Tensor) and rep[k].dim() == 0
    assert int(rep["itr"]) == rref["itr"] and float(rep["tol"]) == rref["tol"]
    assert host == 0
    assert len(out) == len(ref) and all(torch.equal(a, b) for a, b in zip(out, ref))


def test_across_cards_raises_naming_a11f(monkeypatch):
    """A placement over two cards: outside a graph the check passes and the
    solve runs as it is (``sync: True``, or ``sync: False`` as one graph per
    card); inside a ``GraphedCall`` of one graph per card whose lanes are
    the placement's cards (``blocks.card_lanes``; a fused whole step across
    the cards is one), in its eager warm-up and in its capture alike, it
    passes and the solve runs in its per-card form; inside a capture of one
    graph (no lanes, or other lanes), a warm-up of such a call, and a whole
    step of one graph it raises ``NotImplementedError`` naming A11f and the
    lanes capture to use. Blocks on the host raise inside any graph, naming
    A11f."""
    cuda0, cuda1 = torch.device("cuda:0"), torch.device("cuda:1")
    two = SimpleNamespace(devices=(cuda0, cuda1, cuda0, cuda1))
    card_x0 = SimpleNamespace(device=cuda0)
    capturing, lanes = [False], [None]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(dispatch, "graph_lanes", lambda: lanes[0])
    assert dispatch._check_placed(card_x0, two) is False
    assert dispatch._check_placed(torch.zeros(1, 4, 4), two) is False
    lanes[0] = (cuda0, cuda1)  # the warm-up of a call of one graph per card
    assert dispatch._check_placed(card_x0, two) is True
    with whole_step():
        assert dispatch._check_placed(card_x0, two) is True
    for got in ((cuda0,), (cuda1, cuda0)):  # the warm-up of a call of other lanes
        lanes[0] = got
        with pytest.raises(NotImplementedError, match="A11f"):
            dispatch._check_placed(card_x0, two)
    lanes[0] = None
    with pytest.raises(NotImplementedError, match="A11f") as e:
        with whole_step():
            dispatch._check_placed(card_x0, two)
    assert "lanes=blocks.card_lanes(decomp, 'cuda:0')" in str(e.value)
    capturing[0] = True
    for got in (None, (cuda0,), (cuda1, cuda0)):
        lanes[0] = got
        with pytest.raises(NotImplementedError, match="A11f") as e:
            dispatch._check_placed(card_x0, two)
        assert "capture of one graph" in str(e.value)
        assert "(the lanes ['cuda:0', 'cuda:1'])" in str(e.value)
    lanes[0] = (cuda0, cuda1)
    assert dispatch._check_placed(card_x0, two) is True
    one = SimpleNamespace(devices=(cuda0,) * 4)
    assert dispatch._check_placed(card_x0, one) is False
    host = SimpleNamespace(devices=(cuda0, torch.device("cpu")))
    with pytest.raises(NotImplementedError, match="A11f") as e:
        dispatch._check_placed(card_x0, host)
    assert "on the host" in str(e.value)
    capturing[0], lanes[0] = False, None
    assert dispatch._check_placed(card_x0, host) is False
    with pytest.raises(NotImplementedError, match="A11f") as e:
        with whole_step():
            dispatch._check_placed(card_x0, host)
    assert "on the host" in str(e.value)


# -- fused PeriodicFlow LES on placed blocks ------------------------------------

LES_N, LES_STEPS, LES_DT, LES_NU = 33, 5, 0.05, 1.0 / 1600.0


def _port_les(fused: bool):
    """The Smagorinsky Taylor-Green ``PeriodicFlow`` at 33^2 (32^2 on the
    torus) with its solves on placed (2, 2) blocks, ``LES_STEPS`` steps,
    fused or eager: two through ``run``, the rest one by one (the model's
    runner, or ``step``), the viscosity then refreshed as ``run`` does.
    ``(model, itr per solve of the steps after the first two, warnings)``."""
    L = 2 * pi
    mesh = Mesh(Box[0:L, 0:L], None, [LES_N] * 2, device="cpu", dtype="double")
    m = pmodels.PeriodicFlow(mesh, nu=LES_NU, config={"decomp": _placed((2, 2))},
                             mu_strain_fn=smagorinsky_viscosity(LES_NU, mesh, cs=0.17))
    X, Y = mesh.grid
    m.set_velocity(torch.sin(X) * torch.cos(Y), -torch.cos(X) * torch.sin(Y))
    itr = []
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m.run(LES_DT, 2, fused=fused)
        for _ in range(LES_STEPS - 2):
            if fused:
                m.fused_runner().step(LES_DT)
                reports = m.fused_runner().reports
            else:
                with solve_log() as reports:
                    m.step(LES_DT)
            itr += [int(r["itr"]) for r in reports]
    m._refresh_strain_viscosity()
    return m, itr, [str(x.message) for x in w]


def _jax_les():
    """The same run through the JAX package, ``run(fused=True)`` with
    ``DomainDecomposition((2, 2))``: ``(model, warnings)``."""
    L = 2 * pi
    mesh = JMesh(JBox[0:L, 0:L], None, [LES_N] * 2, dtype="double")
    m = jmodels.PeriodicFlow(mesh, nu=LES_NU, config={"decomp": JDD((2, 2))},
                             mu_strain_fn=jsmag(LES_NU, mesh, cs=0.17))
    m.set_velocity(jnp.sin(mesh.X) * jnp.cos(mesh.Y), -jnp.cos(mesh.X) * jnp.sin(mesh.Y))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m.run(LES_DT, LES_STEPS, fused=True)
    return m, [str(x.message) for x in w]


@pytest.fixture(scope="module")
def les_runs():
    return {"fused": _port_les(True), "eager": _port_les(False), "jax": _jax_les()}


def test_fused_placed_les_equals_eager_steps(les_runs):
    """The fused runner over the placed LES: no warning, the eager placed
    steps' ``itr`` solve by solve (the solves inside the whole step report
    device scalars) and their bits, history and clocks included."""
    (mf, itr_f, warn_f), (me, itr_e, _) = les_runs["fused"], les_runs["eager"]
    assert warn_f == []
    assert mf._fused is not None and mf._fused.captures == 0  # the CPU captures nothing
    assert itr_f == itr_e and len(itr_e) == 3 * (LES_STEPS - 2)
    for a, b in zip(mf.state_fields(), me.state_fields()):
        assert torch.equal(a(), b()) and torch.equal(a._VARo, b._VARo), a.name
        assert a.n_hist == b.n_hist and a._t == b._t
    assert torch.equal(mf._nu_field, me._nu_field)


def test_fused_placed_les_matches_jax(les_runs):
    """The port's fused placed run against the JAX package's fused run with
    the decomposition (eager steps there, after its fallback): 1e-10."""
    mf, jm = les_runs["fused"][0], les_runs["jax"][0]
    for a, b in zip(mf.state_fields(), jm.state_fields()):
        np.testing.assert_allclose(a().numpy(), np.asarray(b()), atol=1e-10, rtol=0,
                                   err_msg=a.name)


def test_jax_fused_step_under_a_decomposition_falls_back(les_runs):
    """The reference fault, not copied: the JAX package's fused step under a
    decomposition fails its trace in the host-side separability probe
    (``np.asarray`` of a committed axis vector, a tracer there) and falls
    back to eager steps with a warning; the port's captures the same step
    (on the card) and warns nothing."""
    jwarn = les_runs["jax"][1]
    assert any("fused step capture failed" in w and "TracerArrayConversionError" in w
               for w in jwarn), jwarn
    assert les_runs["fused"][2] == []
