"""The last solver options on a placed decomposition (blocks on their own
devices, ``("cpu",) * n`` here), float64 on the CPU: ``debug: "nan"``,
``donate``, BC values resolved per application (``per_iteration``),
``fdm.custom`` terms and immersed obstacles (``ObstacleDirichlet`` static
and dynamic, ``ObstacleNeumann`` with zero and nonzero flux, under MG).

Each JAX test named below runs its problem four ways: on placed blocks, on
the view-based port with the same ``DomainDecomposition`` shape, through
the JAX package with that decomposition on its 8 virtual CPU devices, and
through the JAX package on one device. The placed run takes the view-based
``itr`` and its solution to 1e-12; the JAX decomposed run the same ``itr``;
both JAX runs the JAX test's own tolerance. The JAX tests' grids are cut
by one node where
their odd node count divides into no blocks (33 -> 32, 97 x 33 -> 96 x 32,
17 -> 16; a periodic axis of 33 nodes is a torus of 32). BiCGSTAB is held
on the solution, not on ``itr``: the per-block partial sums of its dots
round in another order than a global sum, and at its attainable accuracy
that order moves its count (``test_torch_placed.py`` holds it the same
way). Gathers are counted: none in the Krylov loop of an obstacle,
``debug`` or ``donate`` solve, one per custom apply, one per
``per_iteration`` application.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.checkify import JaxRuntimeError  # noqa: E402

from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.geometry import MaskObstacle as JMaskObstacle  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.parallel import DomainDecomposition as JDD  # noqa: E402
from pyapes_tpu.solver.fdm import FDM as JFDM  # noqa: E402
from pyapes_tpu.solver.ops import Solver as JSolver  # noqa: E402
from pyapes_tpu.testing import poisson as jpoisson  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu.variables import bcs as jbcs  # noqa: E402
from pyapes_tpu_torch.geometry import Box, MaskObstacle  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.parallel import DomainDecomposition, blocks  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver, multigrid  # noqa: E402
from pyapes_tpu_torch.solver.linalg import build as build_mod  # noqa: E402
from pyapes_tpu_torch.testing import poisson as ppoisson  # noqa: E402
from pyapes_tpu_torch.utils.debug import NaNError  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables import bcs as pbcs  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401
from test_torch_placed import _GlobalAllocations  # noqa: E402

JAX = SimpleNamespace(Box=JBox, Mask=JMaskObstacle, Field=JField, FDM=JFDM, Solver=JSolver,
                      bcs=jbcs, poisson=jpoisson, arr=jnp.asarray, mean=jnp.mean,
                      Mesh=lambda b, obs, nx: JMesh(b, obs, nx, dtype="double"),
                      DD=JDD, placed=False, OD=jbcs.ObstacleDirichlet)
PORT = SimpleNamespace(Box=Box, Mask=MaskObstacle, Field=Field, FDM=FDM, Solver=Solver,
                       bcs=pbcs, poisson=ppoisson, arr=torch.from_numpy, mean=torch.mean,
                       Mesh=lambda b, obs, nx: Mesh(b, obs, nx, device="cpu", dtype="double"),
                       DD=DomainDecomposition, placed=False, OD=pbcs.ObstacleDirichlet)
PLACED = SimpleNamespace(**{**vars(PORT), "placed": True, "DD": lambda ms: DomainDecomposition(
    ms, devices=("cpu",) * int(np.prod(ms)))})
U2 = (slice(0, 1), slice(0, 1))
SQUARE = (slice(0.4, 0.6), slice(0.4, 0.6))
CG = {"method": "cg", "tol": 1e-12, "max_it": 5000, "report": False, "criterion": "residual"}


def _solve(P, ms, var, lhs, rhs, cfg):
    cfg = dict(cfg)
    if ms is not None:
        cfg["decomp"] = P.DD(ms)
    s = P.Solver({"fdm": {"report": False, **cfg}})
    s.set_eq(lhs == rhs)
    rep = s.solve()
    return np.asarray(var()[0]), rep


def _four(problem, ms, *args):
    """``problem`` placed, view-based and JAX-decomposed on ``ms``, and JAX
    on one device: four ``(solution, report)`` pairs."""
    return (problem(PLACED, ms, *args), problem(PORT, ms, *args), problem(JAX, ms, *args),
            problem(JAX, None, *args))


def _held(runs, atol, same_itr=True):
    """The placed run equals the view-based one (``itr``, 1e-12) and the JAX
    runs agree to ``atol``, the decomposed one with the same ``itr`` where
    ``same_itr`` (the JAX package's one-device count may differ from its
    own decomposed one by the dots' rounding: held on the solution)."""
    (out, rep), (vout, vrep), (jout, jrep), (ref, _) = runs
    assert rep["converge"] and vrep["converge"] and jrep["converge"], (rep, vrep, jrep)
    if same_itr:
        assert rep["itr"] == vrep["itr"] == jrep["itr"], (rep, vrep, jrep)
    np.testing.assert_allclose(out, vout, atol=1e-12, rtol=0)
    for other in (jout, ref):
        np.testing.assert_allclose(out, other, atol=atol, rtol=0)


# -- immersed obstacles (tests/test_obstacle.py, tests/test_multigrid.py) ---


def hot(P, ms, cfg=CG, n=32):
    """``test_hot_obstacle_laplace_vs_dense_oracle``'s problem: the unit
    square at 1 on a Dirichlet body, 0 on the walls."""
    mesh = P.Mesh(P.Box[U2], [P.Box[SQUARE]], [n, n])
    var = P.Field("p", 1, mesh, {"domain": P.bcs.homogeneous_bcs(2, 0.0, "dirichlet"),
                                 "obstacle": [{"bc_type": "dirichlet", "bc_val": 1.0}]})
    return _solve(P, ms, var, P.FDM().laplacian(1.0, var), P.arr(np.zeros((1, n, n))), cfg)


def insulated(P, ms, flux, source, n=32):
    """``test_insulated_obstacle_laplace_vs_dense_oracle`` (zero flux, a
    point source) and ``test_heated_obstacle_nonzero_flux_vs_dense_oracle``
    (flux 5, no source): a Neumann body."""
    mesh = P.Mesh(P.Box[U2], [P.Box[SQUARE]], [n, n])
    var = P.Field("p", 1, mesh, {"domain": P.bcs.homogeneous_bcs(2, 0.0, "dirichlet"),
                                 "obstacle": [{"bc_type": "neumann", "bc_val": flux}]})
    rhs = np.zeros((1, n, n))
    if source:
        rhs[0, n // 4, n // 2] = -1.0
    return _solve(P, ms, var, P.FDM().laplacian(1.0, var), P.arr(rhs), CG)


@pytest.mark.parametrize("ms", [(4, 2), (2, 4)])
def test_hot_obstacle_laplace_vs_dense_oracle(ms):
    """A static Dirichlet body on placed blocks, no gather at all."""
    g0 = blocks.gathers
    runs = _four(hot, ms)
    assert blocks.gathers == g0
    _held(runs, 1e-10)
    assert runs[0][0].max() <= 1.0 + 1e-9 and runs[0][0].min() >= -1e-9


@pytest.mark.parametrize("flux,source", [(0.0, True), (5.0, False)],
                         ids=["insulated_obstacle", "heated_obstacle_nonzero_flux"])
def test_neumann_obstacle_vs_dense_oracle(flux, source):
    """``test_insulated_obstacle_laplace_vs_dense_oracle`` and
    ``test_heated_obstacle_nonzero_flux_vs_dense_oracle``: the shells read
    across block faces (their sources taken from the neighbours' blocks),
    the affine shift built block by block; no gather."""
    g0 = blocks.gathers
    runs = _four(insulated, (4, 2), flux, source)
    assert blocks.gathers == g0
    _held(runs, 1e-10)


def test_obstacle_with_mg_preconditioner():
    """MG-PCG on a Dirichlet body: the plain-domain V-cycle on the placed
    levels (as the whole-tensor path: the Krylov loop masks its output),
    the view-based and JAX ``itr``; gathers only at the V-cycle's
    hand-over to the levels on the lead device."""
    g0, c0 = blocks.gathers, multigrid.cycle_gathers
    runs = _four(hot, (4, 2), {**CG, "precond": "mg"})
    assert blocks.gathers - g0 == multigrid.cycle_gathers - c0
    _held(runs, 1e-10)
    np.testing.assert_allclose(runs[0][0], hot(PLACED, (4, 2))[0], atol=1e-9, rtol=0)


def mg_bicgstab(P, ms, precond):
    """``test_mg_bicgstab_obstacle_poisson``'s problem (96 x 32): a round
    Neumann body, mixed walls, a seeded random RHS, BiCGSTAB."""
    body = P.Mask(lambda X, Y: (X - 0.7) ** 2 + (Y - 0.5) ** 2 < 0.12**2)
    mesh = P.Mesh(P.Box[0:3, 0:1], [body], [96, 32])
    bcs = P.bcs.mixed_bcs([0.0] * 4, ["neumann", "dirichlet", "neumann", "neumann"])
    var = P.Field("p", 1, mesh, {"domain": bcs, "obstacle": [{"bc_type": "neumann",
                                                               "bc_val": 0.0}]}, init_val=0.0)
    rhs = P.arr(np.random.default_rng(0).standard_normal((1, 96, 32)))
    cfg = {"method": "bicgstab", "tol": 1e-8, "max_it": 3000, "criterion": "residual",
           **({"precond": "mg"} if precond else {})}
    return _solve(P, ms, var, P.FDM().laplacian(1.0, var), rhs, cfg)


def test_mg_bicgstab_obstacle_poisson():
    """The JAX test's gates on placed (4, 2) blocks: MG-BiCGSTAB within 25
    iterations and five times fewer than plain BiCGSTAB, the same solution;
    each held to the view-based run and the JAX runs on the solution (the
    JAX test's 1e-6 between them)."""
    plain = _four(mg_bicgstab, (4, 2), False)
    mg = _four(mg_bicgstab, (4, 2), True)
    for runs in (plain, mg):
        (out, rep), (vout, vrep) = runs[:2]
        assert rep["converge"] and vrep["converge"]
        np.testing.assert_allclose(out, vout, atol=1e-7, rtol=0)
        for other, _ in runs[2:]:
            np.testing.assert_allclose(out, other, atol=1e-6, rtol=0)
    assert mg[0][1]["itr"] <= 25 and mg[0][1]["itr"] * 5 < plain[0][1]["itr"]
    np.testing.assert_allclose(mg[0][0], plain[0][0], atol=1e-6, rtol=0)


def dynamic(P, ms, shifts):
    """``test_dynamic_obstacle_with_periodic_axis``'s problem (33 x 33, x
    periodic: a 32-node torus): a body moved between solves."""
    n = 33
    mesh = P.Mesh(P.Box[U2], None, [n, n])
    kinds = ["periodic", "periodic", "dirichlet", "dirichlet"]
    var = P.Field("p", 1, mesh, {"domain": P.bcs.mixed_bcs([None, None, 0.0, 0.0], kinds)})

    def body_at(shift):
        m = np.zeros((n, n), dtype=bool)
        for c in [(8 + shift + k) % (n - 1) for k in range(5)]:
            m[c, 14:19] = True
        return m

    obc = P.OD("body", 1.0, body_at(0), dynamic=True)
    var.bcs.append(obc)
    cfg = {**CG, "decomp": P.DD(ms)} if ms is not None else dict(CG)
    s = P.Solver({"fdm": cfg})
    out = []
    for shift in shifts:
        obc.bc_mask = body_at(shift)
        s.set_eq(P.FDM().laplacian(1.0, var) == P.arr(np.zeros((1, n, n))))
        rep = s.solve()
        out.append((np.asarray(var()[0]).copy(), rep))
    return out, obc


def test_dynamic_obstacle_with_periodic_axis():
    """A moving body on placed (4, 1) blocks of the torus: each solve's mask
    goes to the blocks once (with the operands), none is kept on the BC;
    every position takes the view-based and JAX ``itr`` and values; a body
    on the seam plane raises as before."""
    shifts = (0, 7, 15)
    s0, g0 = blocks.operand_scatters, blocks.gathers
    placed, obc = dynamic(PLACED, (4, 1), shifts)
    assert blocks.operand_scatters - s0 == len(shifts) and blocks.gathers == g0
    assert not obc._dev
    others = [dynamic(P, ms, shifts)[0] for P, ms in ((PORT, (4, 1)), (JAX, (4, 1)),
                                                       (JAX, None))]
    for i in range(len(shifts)):
        _held([placed[i]] + [o[i] for o in others], 1e-10)
        v = placed[i][0]
        np.testing.assert_allclose(v[0, :], v[-1, :], atol=1e-12, rtol=0)
    seam = np.zeros((33, 33), dtype=bool)
    seam[-1, 14:19] = True
    mesh = Mesh(Box[U2], None, [33, 33], device="cpu", dtype="double")
    kinds = ["periodic", "periodic", "dirichlet", "dirichlet"]
    var = Field("p", 1, mesh, {"domain": pbcs.mixed_bcs([None, None, 0.0, 0.0], kinds)})
    var.bcs.append(pbcs.ObstacleDirichlet("body", 1.0, seam, dynamic=True))
    s = Solver({"fdm": {**CG, "decomp": PLACED.DD((4, 1))}})
    s.set_eq(FDM().laplacian(1.0, var) == torch.zeros(1, 33, 33, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="seam"):
        s.solve()


def _body3d(P, flux):
    """A 3-D Neumann body whose shells lie next to block faces on every cut
    axis, seeded RHS: ``(var, lhs, rhs)``."""
    n = 16
    mesh = P.Mesh(P.Box[(slice(0, 1),) * 3], [P.Box[0.3:0.55, 0.2:0.45, 0.35:0.6]], [n] * 3)
    var = P.Field("p", 1, mesh, {"domain": P.bcs.homogeneous_bcs(3, 0.0, "dirichlet"),
                                 "obstacle": [{"bc_type": "neumann", "bc_val": flux}]},
                  init_val=0.0)
    rhs = P.arr(np.random.default_rng(3).standard_normal((1, n, n, n)))
    return var, P.FDM().laplacian(1.0, var), rhs


def test_neumann_shells_read_across_blocks_and_allocate_nothing_global(monkeypatch):
    """A 3-D Neumann body with nonzero flux on placed (2, 2, 2) blocks: some
    shell sources lie in a neighbour's block and only those cells are
    copied; the loop allocates no grid-sized tensor and gathers nothing;
    the view-based ``itr`` and solution (1e-12)."""
    modes = []
    real = build_mod.build_cg

    def counted_build(*a, **k):
        fn = real(*a, **k)

        def run(x0, rhs, *rest, **kw):
            mode = _GlobalAllocations(x0.numel())
            modes.append(mode)
            with mode:
                return fn(x0, rhs, *rest, **kw)

        return run

    monkeypatch.setattr(build_mod, "build_cg", counted_build)
    g0 = blocks.gathers
    var, lhs, rhs = _body3d(PLACED, 2.0)
    cfg = {**CG, "max_it": 1000}  # a history of fewer entries than the grid's nodes
    out, rep = _solve(PLACED, (2, 2, 2), var, lhs, rhs, cfg)
    assert blocks.gathers == g0 and len(modes) == 1 and modes[0].hits == []
    obn = next(bc for bc in var.bcs if bc.bc_type == "obstacle_neumann")
    lay = blocks.layout(PLACED.DD((2, 2, 2)), (16, 16, 16), torch.device("cpu"))
    across = [o for plan in obn._block_plans(lay) for b, bp in enumerate(plan)
              if bp is not None for o, _ in bp[4] if o != b]
    assert across
    monkeypatch.setattr(build_mod, "build_cg", real)
    var2, lhs2, rhs2 = _body3d(PORT, 2.0)
    ref, rref = _solve(PORT, (2, 2, 2), var2, lhs2, rhs2, cfg)
    assert rep["converge"] and rep["itr"] == rref["itr"]
    np.testing.assert_allclose(out, ref, atol=1e-12, rtol=0)


@pytest.mark.parametrize("flux", [0.0, 2.0])
def test_block_shells_and_affine_field_equal_the_whole_tensor(flux):
    """``apply_linear``, ``apply_`` and ``affine_field`` of a Neumann body on
    a block vector equal the whole tensor's, bit for bit."""
    var, _, _ = _body3d(PORT, flux)
    obn = next(bc for bc in var.bcs if bc.bc_type == "obstacle_neumann")
    lay = blocks.layout(PLACED.DD((2, 2, 2)), (16, 16, 16), torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 16, 16, 16)))
    xb = blocks.scatter(x, lay)
    assert torch.equal(blocks.gather(obn.apply_linear(xb), count=False), obn.apply_linear(x))
    assert torch.equal(blocks.gather(obn.apply_(xb.clone(), None), count=False),
                       obn.apply_(x.clone(), None))
    e = obn.affine_field((2, 16, 16, 16), torch.float64, lay)
    assert isinstance(e, blocks.BlockTensor)
    assert torch.equal(blocks.gather(e, count=False),
                       obn.affine_field((2, 16, 16, 16), torch.float64, "cpu"))


# -- debug: "nan" (tests/test_solver.py) -------------------------------------


def _nan_problem(P, ms, rhs):
    mesh = P.Mesh(P.Box[U2], None, [16, 16])
    var = P.Field("p", 1, mesh, {"domain": P.bcs.homogeneous_bcs(2, 0.0, "dirichlet")},
                  init_val=0.0)
    cfg = {"method": "cg", "tol": 1e-8, "max_it": 50, "debug": "nan"}
    return _solve(P, ms, var, P.FDM().laplacian(1.0, var), P.arr(rhs), cfg)


def test_debug_nan_checkify():
    """``test_debug_nan_checkify`` on placed (2, 2) blocks (16^2): a NaN
    planted in the last block, not the lead's, raises ``NaNError`` naming
    the operation the view-based solve names, with no gather; the JAX
    decomposed solve raises too; the clean problem passes through the
    checked path with the view-based ``itr`` and solution."""
    rhs = np.zeros((1, 16, 16))
    rhs[0, 12, 12] = np.nan
    g0 = blocks.gathers
    with pytest.raises(NaNError) as placed:
        _nan_problem(PLACED, (2, 2), rhs)
    assert blocks.gathers == g0
    with pytest.raises(NaNError) as view:
        _nan_problem(PORT, (2, 2), rhs)
    assert placed.value.op == view.value.op
    with pytest.raises((JaxRuntimeError, ValueError, RuntimeError)):
        _nan_problem(JAX, (2, 2), rhs)
    _held(_four(_nan_problem, (2, 2), np.ones((1, 16, 16))), 1e-12)
    assert blocks.gathers == g0


def test_debug_nan_checks_blocks_without_gathering():
    """The check of a block vector flags each block on its own device: a
    NaN in one block is found, nothing is gathered."""
    from pyapes_tpu_torch.utils.debug import nan_check

    lay = blocks.layout(PLACED.DD((2, 2)), (8, 8), torch.device("cpu"))
    x = torch.ones(1, 8, 8, dtype=torch.float64)
    x[0, 6, 5] = np.nan
    xb = blocks.scatter(x, lay)
    g0 = blocks.gathers
    with pytest.raises(NaNError, match="aten.mul.Tensor"):
        with nan_check():
            y = xb * 2.0
    assert isinstance(y, blocks.BlockTensor) and blocks.gathers == g0


# -- donate (tests/test_solver.py) -------------------------------------------


def _donate_problem(P, ms, donate, on_blocks=False):
    mesh = P.Mesh(P.Box[U2], None, [32, 32])
    var = P.Field("p", 1, mesh, {"domain": P.poisson.poisson_bcs(2), "obstacle": None})
    if on_blocks:
        var.VAR = blocks.put(var(), P.DD(ms))
    rhs = P.poisson.poisson_rhs_nd(mesh, var)
    cfg = {"method": "cg", "tol": 1e-9, "max_it": 500, "donate": donate}
    x0 = var()
    ptrs = ([p.data_ptr() for p in x0.parts] if isinstance(x0, blocks.BlockTensor)
            else [x0.data_ptr()] if isinstance(x0, torch.Tensor) else None)
    out, rep = _solve(P, ms, var, P.FDM().laplacian(1.0, var), rhs, cfg)
    x = var()
    if ptrs is not None:
        now = ([p.data_ptr() for p in x.parts] if isinstance(x, blocks.BlockTensor)
               else [x.data_ptr()])
        rep = {**rep, "same_storage": now == ptrs}
    return out, rep


@pytest.mark.parametrize("on_blocks", [False, True], ids=["whole_field", "block_field"])
def test_donate_initial_guess(on_blocks):
    """``test_donate_initial_guess`` (32^2) on placed (2, 4) blocks: the
    donated solve gives the undonated bits and report; a block Field's
    solution is in its own blocks' storage (each block's ``data_ptr``
    unchanged), a whole Field's exit gather writes into its ``x0``; no
    gather; the view-based and JAX (donated, decomposed) runs agree."""
    g0 = blocks.gathers
    ref, rref = _donate_problem(PLACED, (2, 4), False, on_blocks)
    out, rep = _donate_problem(PLACED, (2, 4), True, on_blocks)
    assert blocks.gathers == g0
    assert rep.pop("same_storage") and not rref.pop("same_storage")
    assert rep == rref and np.array_equal(out, ref)
    _held([(out, rep), _donate_problem(PORT, (2, 4), True), _donate_problem(JAX, (2, 4), True),
           _donate_problem(JAX, None, True)], 1e-12)


# -- per_iteration BC values (tests/test_streaming.py) -----------------------


def _per_iteration(P, ms, nx=(16,), seed=None):
    """``test_per_iteration_callable_opt_out``'s problem (16 nodes; with
    ``nx`` 2-D and a seeded RHS, a nontrivial one): the upper x face chases
    half the iterate's mean, resolved at every application."""
    mesh = P.Mesh(P.Box[(slice(0, 1),) * len(nx)], None, list(nx))

    def follower(grid, mask, var, opt):
        return 0.5 * P.mean(var)

    bcs = [{"bc_face": "xl", "bc_type": "dirichlet", "bc_val": 0.0, "bc_val_opt": None},
           {"bc_face": "xu", "bc_type": "dirichlet", "bc_val": follower,
            "bc_val_opt": {"per_iteration": True}}]
    bcs += [{"bc_face": f, "bc_type": "dirichlet", "bc_val": 0.0, "bc_val_opt": None}
            for f in ("yl", "yu")[:2 * (len(nx) - 1)]]
    var = P.Field("u", 1, mesh, {"domain": bcs}, init_val=0.0)
    rhs = (np.zeros((1, *nx)) if seed is None
           else np.random.default_rng(seed).standard_normal((1, *nx)))
    cfg = {"method": "cg", "tol": 1e-8, "max_it": 200}
    return _solve(P, ms, var, P.FDM().laplacian(1.0, var), P.arr(rhs), cfg)


@pytest.mark.parametrize("nx,ms,seed", [((16,), (4,), None), ((16, 16), (2, 2), 5)],
                         ids=["jax_problem_1d", "random_2d"])
def test_per_iteration_callable_opt_out(nx, ms, seed):
    """The callable sees the iterate at each application: on placed blocks
    through one counted gather per application (CG applies the BCs at its
    entry and its exit: two), the view-based ``itr`` and solution."""
    p0, g0 = blocks.per_iteration_gathers, blocks.gathers
    placed = _per_iteration(PLACED, ms, nx, seed)
    assert blocks.per_iteration_gathers - p0 == 2
    if len(nx) > 1:  # the 2-D stencil applies block by block: no other gather
        assert blocks.gathers - g0 == 2
    _held([placed] + [_per_iteration(P, m, nx, seed) for P, m in ((PORT, ms), (JAX, ms),
                                                                   (JAX, None))], 1e-10)


# -- fdm.custom (tests/test_streaming.py) -----------------------------------


def _custom(P, ms, calls):
    n = 16
    mesh = P.Mesh(P.Box[0:1], None, [n])
    var = P.Field("u", 1, mesh, {"domain": P.bcs.homogeneous_bcs(1, 0.0, "dirichlet")})

    def op(x):
        calls.append(type(x))
        return 2.0 * x

    cfg = {"method": "bicgstab", "tol": 1e-8, "max_it": 200}
    return _solve(P, ms, var, P.FDM().custom(op, var), P.arr(np.ones((1, n))), cfg)


def test_custom_fn_content_key():
    """``test_custom_fn_content_key`` (16 nodes) on placed (2,) blocks: three
    fresh, identical closures; the opaque operator applies on the lead
    device, one counted gather per apply (it sees a whole plain tensor);
    the interior at 0.5; the view-based run's report and solution."""
    for _ in range(3):
        calls = []
        g0 = blocks.gathers
        out, rep = _custom(PLACED, (2,), calls)
        assert calls and blocks.gathers - g0 == len(calls)
        assert all(c is torch.Tensor for c in calls)
        np.testing.assert_allclose(out[1:-1], 0.5, atol=1e-6)
        vout, vrep = _custom(PORT, (2,), [])
        assert rep == vrep
        np.testing.assert_allclose(out, vout, atol=1e-12, rtol=0)
    jout, _ = _custom(JAX, (2,), [])
    np.testing.assert_allclose(out, jout, atol=1e-12, rtol=0)


def _custom3d(P, ms, precond, calls):
    """A 3-D custom operator (a weighted diagonal minus the 6 neighbours)
    with a separable ``fd_hint``, BiCGSTAB."""
    n = 16
    mesh = P.Mesh(P.Box[(slice(0, 1),) * 3], None, [n] * 3)
    var = P.Field("u", 1, mesh, {"domain": P.bcs.homogeneous_bcs(3, 0.0, "dirichlet")},
                  init_val=0.0)
    rng = np.random.default_rng(8)
    w = P.arr(1.0 + 0.2 * rng.random((n, n, n)))
    roll = jnp.roll if P is JAX else torch.roll

    def op(x, c):
        calls.append(1)
        nb = sum(roll(x, s, a) for a in (1, 2, 3) for s in (1, -1))
        return 6.0 * c * x - 0.9 * nb

    hint = tuple(tuple(np.full(n, v) for v in (-0.9, 2.4, -0.9)) for _ in range(3))
    cfg = {"method": "bicgstab", "tol": 1e-10, "max_it": 300, "criterion": "residual",
           "precond": precond}
    rhs = P.arr(rng.standard_normal((1, n, n, n)))
    return _solve(P, ms, var, P.FDM().custom(op, var, params=(w,), fd_hint=hint), rhs, cfg)


def test_custom_term_with_fd_hint_and_precond_fd():
    """A 3-D custom term whose ``fd_hint`` feeds the placed FD
    preconditioner (pencil transforms): one gather per custom apply, the
    view-based ``itr`` and solution (1e-12); fewer iterations than without
    the preconditioner; the JAX decomposed solve agrees."""
    calls = []
    g0 = blocks.gathers
    out, rep = _custom3d(PLACED, (2, 2, 2), "fd", calls)
    assert blocks.gathers - g0 == len(calls) and rep["converge"]
    vout, vrep = _custom3d(PORT, (2, 2, 2), "fd", [])
    assert rep["itr"] == vrep["itr"]
    np.testing.assert_allclose(out, vout, atol=1e-12, rtol=0)
    plain, prep = _custom3d(PLACED, (2, 2, 2), None, [])
    assert rep["itr"] < prep["itr"]
    jout, _ = _custom3d(JAX, (2, 2, 2), "fd", [])
    np.testing.assert_allclose(out, jout, atol=1e-9, rtol=0)
    np.testing.assert_allclose(out, plain, atol=1e-8, rtol=0)

