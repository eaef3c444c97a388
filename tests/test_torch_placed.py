"""Placed decompositions on the CPU: every block of a loop vector its own
allocation (``parallel/blocks.py``), the placed halo apply, the pencil
repartitions of the fast-diagonalization transforms and the solver paths
that run on block vectors, against the view-based decomposition and the
JAX package's device-count check.

The blocks are placed on ``("cpu",) * n``: each block is then its own
allocation, and the exchange and the reductions are explicit copies. The
solves are float64 and small (at most 16 x 16 x 128).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops.stencil import apply_axis_stencil  # noqa: E402
from pyapes_tpu_torch.parallel import DomainDecomposition, blocks, halo  # noqa: E402
from pyapes_tpu_torch.parallel.decomp import pencil_plan  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.solver import multigrid  # noqa: E402
from pyapes_tpu_torch.solver.linalg import build as build_mod  # noqa: E402
from pyapes_tpu_torch.solver.linalg.fastdiag_loop import _l2_per_dim, _vsum  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import homogeneous_bcs, mixed_bcs  # noqa: E402

CPU = torch.device("cpu")


def _placed(ms, device="cpu"):
    return DomainDecomposition(ms, devices=(device,) * int(np.prod(ms)))


def _problem(nx, seed=0, kinds=None):
    """A float64 Laplacian on the unit box, homogeneous Dirichlet faces (or
    ``kinds``, per face, value 0), with a seeded random RHS."""
    mesh = Mesh(Box[(slice(0, 1),) * len(nx)], None, list(nx), device="cpu", dtype="double")
    bcs = (homogeneous_bcs(len(nx), 0.0, "dirichlet") if kinds is None
           else mixed_bcs([0.0] * len(kinds), kinds))
    var = Field("p", 1, mesh, {"domain": bcs, "obstacle": None}, init_val=0.0)
    rhs = torch.from_numpy(np.random.default_rng(seed).standard_normal((1, *nx)))
    return mesh, var, rhs


def _solve(nx, cfg, decomp=None, seed=0, kinds=None):
    _, var, rhs = _problem(nx, seed, kinds)
    if decomp is not None:
        cfg = {**cfg, "decomp": decomp}
    s = Solver({"fdm": {"report": False, **cfg}})
    s.set_eq(FDM().laplacian(1.0, var) == rhs)
    rep = s.solve()
    return var()[0].clone(), rep


CG = {"method": "cg", "tol": 1e-10, "max_it": 600, "criterion": "residual"}
BICG = {"method": "bicgstab", "tol": 1e-10, "max_it": 600, "criterion": "residual"}
MG = {**CG, "precond": "mg", "mg_opts": {"n_pre": 1, "n_post": 1}}
FD = {"method": "fastdiag", "tol": 1e-10, "max_it": 50, "criterion": "residual"}
# the solves of the fast-diagonalization path, by the name of their loop's builder
FD_PATHS = {"fastdiag": (FD, "build_fastdiag"), "cg_fd": ({**CG, "precond": "fd"}, "build_cg"),
            "bicgstab_fd": ({**BICG, "precond": "fd"}, "build_bicgstab")}
MIXED = ["neumann", "dirichlet", "symmetry", "dirichlet", "dirichlet", "dirichlet"]


def test_blocks_are_separate_storages_on_their_devices():
    dd = _placed((4, 2, 1))
    lay = blocks.layout(dd, (8, 8, 16), CPU)
    x = torch.randn(2, 8, 8, 16, dtype=torch.float64)
    xb = blocks.scatter(x, lay)
    assert isinstance(xb, blocks.BlockTensor) and xb.shape == x.shape and xb.device == CPU
    assert len(xb.parts) == 8 and all(p.device == d for p, d in zip(xb.parts, lay.devices))
    ptrs = {p.untyped_storage().data_ptr() for p in xb.parts}
    assert len(ptrs) == 8 and x.untyped_storage().data_ptr() not in ptrs
    for p, (_, sl, _) in zip(xb.parts, lay.blocks):
        assert p.is_contiguous() and torch.equal(p, x[(slice(None), *sl)])
    y = xb * 2.0 + xb  # the operations keep the blocks
    assert isinstance(y, blocks.BlockTensor) and len({p.data_ptr() for p in y.parts}) == 8
    g0 = blocks.gathers
    assert torch.equal(blocks.gather(y, count=False), 3.0 * x) and blocks.gathers == g0
    assert blocks.scatter(xb, lay) is xb


def test_placement_of_the_decomposition():
    dd = DomainDecomposition((2, 2), devices=("cpu",) * 6)  # more entries: the first four
    assert dd.placed and dd.devices == (CPU,) * 4
    pl = dd.placement((6, 4))
    assert [c for c, _, _ in pl] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert pl[3][1] == (slice(3, 6), slice(2, 4)) and pl[3][2] == CPU
    assert DomainDecomposition((2, 2)).placement((6, 4))[0][2] is None
    assert not DomainDecomposition((2, 2)).placed


def test_too_few_devices_raises_as_the_jax_package():
    import jax

    from pyapes_tpu.parallel import DomainDecomposition as JDD

    with pytest.raises(AssertionError) as jerr:
        JDD((4, 2, 2), devices=tuple(jax.devices())).device_mesh()
    n = len(jax.devices())
    with pytest.raises(ValueError) as err:
        DomainDecomposition((4, 2, 2), devices=("cpu",) * n)
    assert str(err.value) == str(jerr.value) == f"DomainDecomposition: needs 16 devices, have {n}"


def test_a_device_the_machine_lacks_raises():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="does not exist"):
        DomainDecomposition((2, 1), devices=("cpu", f"cuda:{n}"))
    with pytest.raises(ValueError, match="not a CPU or CUDA device"):
        DomainDecomposition((2, 1), devices=("cpu", "meta"))


def _ghost_bytes(ms, shape, itemsize):
    """Bytes of the ghost faces of every block: two faces per cut axis,
    each the block's extent on the other axes."""
    local = [n // m for n, m in zip(shape[1:], ms)]
    total = 0
    for j, m in enumerate(ms):
        if m > 1:
            total += 2 * shape[0] * int(np.prod(local)) // local[j] * itemsize
    return int(np.prod(ms)) * total


@pytest.mark.parametrize("ms,shape", [((4, 2, 1), (1, 16, 16, 32)), ((2, 2, 2), (2, 8, 8, 8)),
                                      ((4, 1), (1, 32, 12))])
def test_exchange_moves_the_ghost_faces_only(ms, shape):
    """One placed apply copies exactly the ghost faces between blocks and
    equals the global apply."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(shape))
    coeffs = tuple(tuple(torch.from_numpy(rng.standard_normal(n)) for _ in range(3))
                   for n in shape[1:])
    dd = _placed(ms)
    assert halo.placed_supported(dd, shape[1:])
    xb = blocks.scatter(x, blocks.layout(dd, shape[1:], CPU))
    apply = halo.make_sharded_apply(dd, len(shape) - 1)
    b0, a0, g0 = halo.exchange_bytes, halo.placed_applies, blocks.gathers
    out = apply(coeffs, xb)
    assert halo.exchange_bytes - b0 == _ghost_bytes(ms, shape, 8)
    assert halo.placed_applies - a0 == 1 and blocks.gathers == g0
    np.testing.assert_allclose(blocks.gather(out).numpy(), apply_axis_stencil(coeffs, x).numpy(),
                               atol=1e-13, rtol=0)


def test_reductions_sum_in_block_order():
    dd = _placed((4, 2, 1))
    lay = blocks.layout(dd, (8, 8, 16), CPU)
    rng = np.random.default_rng(5)
    x, y = (blocks.scatter(torch.from_numpy(rng.standard_normal((2, 8, 8, 16))), lay)
            for _ in range(2))
    s1, s2 = _vsum(x * y), _vsum(x * y)
    assert not isinstance(s1, blocks.BlockTensor) and s1.shape == (2, 1, 1, 1)
    assert torch.equal(s1, s2)
    acc = None
    for px, py in zip(x.parts, y.parts):  # block order
        p = torch.sum(px * py, dim=(1, 2, 3), keepdim=True)
        acc = p if acc is None else acc + p
    assert torch.equal(s1, acc)
    assert torch.equal(_l2_per_dim(x), _l2_per_dim(x))
    np.testing.assert_allclose(_l2_per_dim(x).numpy(),
                               torch.linalg.vector_norm(blocks.gather(x).reshape(2, -1),
                                                        dim=1).numpy(), rtol=1e-14)
    assert torch.equal(x.max(), blocks.gather(x).max())


def test_pencil_plans():
    """The transform order and the pencil of each axis: the axes whole in
    the solve's cut first, each next axis's blocks handed to a whole axis
    where one divides; a grid no pencil divides raises."""
    assert pencil_plan((4, 2, 1), (512,) * 3) == ((2, (4, 2, 1)), (0, (1, 2, 4)), (1, (2, 1, 4)))
    assert pencil_plan((2, 4), (64, 64)) == ((0, (1, 8)), (1, (8, 1)))
    assert pencil_plan((8, 1), (64, 64)) == ((1, (8, 1)), (0, (1, 8)))
    assert pencil_plan((2, 2, 2), (12, 12, 12)) == ((0, (1, 2, 4)), (1, (2, 1, 4)), (2, (2, 4, 1)))
    with pytest.raises(NotImplementedError, match="no pencil makes axis 0"):
        pencil_plan((2, 1, 1), (6, 5, 5))
    dd = _placed((4, 2, 1))
    assert dd.pencil((1, 2, 4)).devices == dd.devices and dd.pencil((4, 2, 1)) == dd
    with pytest.raises(ValueError, match="pencil cut"):
        dd.pencil((2, 2, 1))


@pytest.mark.parametrize("ms,shape", [((4, 2, 1), (2, 16, 16, 32)), ((2, 2, 2), (1, 12, 12, 12)),
                                      ((2, 4), (1, 32, 24)), ((8, 1), (1, 64, 16))])
def test_repartition_round_trips_bit_for_bit(ms, shape):
    """Through every pencil of the plan and back: the same bits; each
    destination block its own contiguous allocation on its device; every
    element copied once per move (all within one device here); nothing
    gathered, and the source vector left as it was."""
    lay = blocks.layout(_placed(ms), shape[1:], CPU)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape))
    xb = blocks.scatter(x, lay)
    c0 = (blocks.repartitions, blocks.repartition_bytes_within, blocks.repartition_bytes_across,
          blocks.gathers)
    y, moves = xb, 0
    for axis, pen in lay.pencils():
        assert pen.ms[axis] == 1 and np.prod(pen.ms) == np.prod(lay.ms)
        assert pen.devices == lay.devices and pen.grid == lay.grid
        moves += pen is not y.placement
        y = blocks.repartition(y, pen)
        assert isinstance(y, blocks.BlockTensor) and y.placement is pen and y.shape == x.shape
        for p, (_, sl, dev) in zip(y.parts, pen.blocks):
            assert p.device == dev and p.is_contiguous() and torch.equal(p, x[(slice(None), *sl)])
    moves += y.placement is not lay
    back = blocks.repartition(y, lay)
    assert all(torch.equal(p, q) for p, q in zip(back.parts, xb.parts))
    assert torch.equal(blocks.gather(xb, count=False), x)
    assert blocks.repartition(xb, lay) is xb
    assert moves >= 2
    assert (blocks.repartitions, blocks.repartition_bytes_within, blocks.repartition_bytes_across,
            blocks.gathers) == (c0[0] + moves, c0[1] + moves * x.numel() * 8, c0[2], c0[3])


@pytest.mark.parametrize("ms,nx,pseudo", [((4, 2, 1), (16, 16, 32), False),
                                          ((2, 4), (32, 24), True)])
def test_solve_blocks_is_the_active_set_solve(ms, nx, pseudo):
    """``FastDiag.solve_blocks`` on a block vector that is 0 off the active
    set gives ``solve`` of the active set there (1e-13) and exact zeros
    elsewhere, with one repartition per pencil change: 4 per apply at
    (4, 2, 1) and (2, 4), each moving the whole vector."""
    slicer = tuple(slice(1, n - 1) for n in nx)
    rng = np.random.default_rng(4)
    coeffs = [(np.full(n, 1.0), np.full(n, -2.0 - 0.1 * pseudo), np.full(n, 1.0)) for n in nx]
    fd = build_mod.fastdiag_factors(((1.0, coeffs),), slicer, (), torch.float64, CPU)
    r = torch.zeros((1, *nx), dtype=torch.float64)
    act = (slice(None), *slicer)
    r[act] = torch.from_numpy(rng.standard_normal((1, *(n - 2 for n in nx))))
    lay = blocks.layout(_placed(ms), nx, CPU)
    r0, w0 = blocks.repartitions, blocks.repartition_bytes_within
    got = blocks.gather(fd.solve_blocks(blocks.scatter(r, lay), slicer, 1.5, 0.25, pseudo),
                        count=False)
    want = fd.solve(r[act].contiguous(), 1.5, 0.25, pseudo)
    np.testing.assert_allclose(got[act].numpy(), want.numpy(), atol=1e-13, rtol=0)
    off = torch.ones_like(r, dtype=torch.bool)
    off[act] = False
    assert torch.count_nonzero(got[off]) == 0
    assert blocks.repartitions - r0 == 4
    assert blocks.repartition_bytes_within - w0 == 4 * r.numel() * 8


class _GlobalAllocations(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts operations that return a plain tensor of at least ``numel``
    elements in a storage of their own (a block vector holds no storage; a
    view of an input, such as a GEMM's broadcast of an n x n factor,
    allocates nothing)."""

    def __init__(self, numel):
        super().__init__()
        self.numel, self.hits = numel, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        big = [t for t in torch.utils._pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor) and not isinstance(t, blocks.BlockTensor)
               and t.numel() >= self.numel]
        if big:
            inputs = {t.untyped_storage().data_ptr()
                      for t in torch.utils._pytree.tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor) and not isinstance(t, blocks.BlockTensor)}
            self.hits += [str(func) for t in big if t.untyped_storage().data_ptr() not in inputs]
        return out


@pytest.mark.parametrize("method", ["cg", "bicgstab", *FD_PATHS])
@pytest.mark.parametrize("ms,nx", [((4, 2, 1), (16, 16, 32)), ((2, 2, 2), (12, 12, 12)),
                                   ((4, 1), (32, 24))])
def test_placed_loop_allocates_nothing_global_and_gathers_nothing(method, ms, nx, monkeypatch):
    """Between the scatter and the gather, a placed CG or BiCGSTAB solve
    (plain or with the FD preconditioner) or fastdiag solve allocates no
    tensor of the global size on any device and makes no gather: zero per
    iteration. The eigen-transforms move blocks between pencils instead
    (``blocks.repartitions``)."""
    modes = []
    cfg, name = FD_PATHS.get(method) or ({"cg": CG, "bicgstab": BICG}[method],
                                         {"cg": "build_cg", "bicgstab": "build_bicgstab"}[method])
    real = getattr(build_mod, name)

    def counted_build(*a, **k):
        fn = real(*a, **k)

        def run(x0, rhs, *rest, **kw):
            assert isinstance(x0, blocks.BlockTensor) and isinstance(rhs, blocks.BlockTensor)
            mode = _GlobalAllocations(x0.numel())
            modes.append(mode)
            with mode:
                out = fn(x0, rhs, *rest, **kw)
            assert isinstance(out[0], blocks.BlockTensor)
            return out

        return run

    monkeypatch.setattr(build_mod, name, counted_build)
    g0, r0 = blocks.gathers, blocks.repartitions
    _, rep = _solve(nx, cfg, _placed(ms))
    # with the FD inverse (exact in f64) a solve takes one pass
    assert rep["converge"] and rep["itr"] >= (1 if method in FD_PATHS else 6)
    assert len(modes) == 1 and modes[0].hits == []
    assert blocks.gathers == g0
    assert (blocks.repartitions > r0) == (method in FD_PATHS)


@pytest.mark.parametrize("method", ["cg", "bicgstab", "mg", "mg_bicgstab", "fastdiag",
                                    "fastdiag_mean", "cg_fd", "bicgstab_fd"])
def test_placed_solve_equals_the_view_based_one(method):
    """The placed CG and MG-PCG solves take the view-based decomposition's
    iterations and its solution to 1e-12; Neumann and Symmetry faces on
    cut axes (the BCs written into the edge blocks, the 3/2 row scale as
    block vectors) in those cases. The dots sum per-block partials, in
    another order than the global sum: BiCGSTAB at tol 1e-10 ends at its
    attainable accuracy, where that order moves its count, so it is held to
    ``|d itr| <= 2`` and 1e-9, as ``test_torch_decomp.py`` holds the JAX
    package's own decomposed BiCGSTAB runs. The fastdiag solve (mixed faces;
    all-Neumann on the zero-mean quotient space) and CG (mixed faces: the
    3/2 row scale before the eigen-solve) and BiCGSTAB with the FD
    preconditioner take the view-based itr and solution to 1e-12."""
    cfg = {"cg": CG, "bicgstab": BICG, "mg": MG,
           "mg_bicgstab": {**BICG, "precond": "mg", "mg_opts": {"n_pre": 1, "n_post": 1}},
           "fastdiag_mean": {**FD, "nullspace": "mean"},
           **{k: c for k, (c, _) in FD_PATHS.items()}}[method]
    kinds = {"cg": MIXED, "mg": MIXED, "fastdiag": MIXED, "cg_fd": MIXED,
             "fastdiag_mean": ["neumann"] * 6}.get(method)
    ref, rref = _solve((16, 16, 32), cfg, DomainDecomposition((4, 2, 1)), 7, kinds)
    out, rep = _solve((16, 16, 32), cfg, _placed((4, 2, 1)), 7, kinds)
    slack, atol = (2, 1e-9) if method.endswith("bicgstab") else (0, 1e-12)
    assert rep["converge"] and abs(rep["itr"] - rref["itr"]) <= slack, (rep, rref)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=atol, rtol=0)


def test_placed_mg_gathers_only_in_its_transfers():
    """Per V-cycle, the placed MG gathers once: the hand-over from the
    coarsest placed level to the first level on the lead device (the
    transfers between placed levels run block by block; the way back is a
    scatter), and CG itself gathers nothing."""
    v0, c0, g0 = multigrid.vcycles, multigrid.cycle_gathers, blocks.gathers
    _, rep = _solve((16, 16, 32), MG, _placed((4, 2, 1)), 2)
    cycles, in_cycles = multigrid.vcycles - v0, multigrid.cycle_gathers - c0
    # levels 16x16x32 and 8x8x16 take (4, 2, 1) blocks, 4x4x8 does not
    shapes = multigrid._level_shapes((16, 16, 32))
    placed = [halo.placed_supported(_placed((4, 2, 1)), s) for s in shapes]
    assert placed == [True, True, False]
    assert cycles == rep["itr"] + 1 and in_cycles == cycles
    assert blocks.gathers - g0 == in_cycles


def _flow(decomp):
    """Two Taylor-Green steps of ``PeriodicFlow`` at 17^2 (16^2 on the
    torus): ``(u, the last momentum solve's report)``."""
    from math import pi

    from pyapes_tpu_torch.models import PeriodicFlow

    mesh = Mesh(Box[0:1, 0:1], None, [17, 17], device="cpu", dtype="double")
    model = PeriodicFlow(mesh, config={"decomp": decomp})
    k = 2 * pi
    model.set_velocity(-torch.cos(k * mesh.X) * torch.sin(k * mesh.Y),
                       torch.sin(k * mesh.X) * torch.cos(k * mesh.Y))
    model.run(2e-3, 2)
    return model.u()[0].clone(), model.mom_solver.report


def _unported(case, decomp=None):
    """The case's solve on ``decomp`` (default: placed (2, 1, 1) blocks, or
    (2, 2) for the flow): ``(solution, report)``."""
    if case == "periodic_flow":
        return _flow(decomp or _placed((2, 2)))
    mesh, var, rhs = _problem((16, 8, 8))
    cfg = {**CG, "max_it": 5}
    fdm = FDM()
    lhs = fdm.laplacian(1.0, var)
    if case == "var_gamma":
        lhs = fdm.laplacian(torch.ones(16, 8, 8, dtype=torch.float64), var)
    elif case in ("div", "conv"):
        adv = torch.ones(3 if case == "conv" else 1, 16, 8, 8, dtype=torch.float64)
        lhs = (fdm.conv(adv, var) if case == "conv" else fdm.div(adv, var)) - lhs
        cfg["method"] = "bicgstab"
    elif case == "custom":
        lhs = fdm.custom(lambda x: 2.0 * x, var)
    elif case == "obstacle":
        mesh = Mesh(Box[0:1, 0:1, 0:1], [Box[0.4:0.6, 0.4:0.6, 0.4:0.6]], [16, 8, 8],
                    device="cpu", dtype="double")
        var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet"),
                                   "obstacle": [{"bc_type": "dirichlet", "bc_val": 1.0}]})
        lhs = fdm.laplacian(1.0, var)
    elif case == "donate":
        cfg["donate"] = True
    elif case == "debug_nan":
        cfg["debug"] = "nan"
    return _unported_solve(var, lhs, rhs, cfg, decomp)


def _unported_solve(var, lhs, rhs, cfg, decomp=None):
    s = Solver({"fdm": {**cfg, "decomp": decomp or _placed((2, 1, 1))}})
    s.set_eq(lhs == rhs)
    rep = s.solve()
    return var()[0].clone(), rep


@pytest.mark.parametrize("case", ["var_gamma", "div", "conv", "periodic_flow", "custom",
                                  "obstacle", "donate", "debug_nan"])
def test_formerly_unported_cases_solve_placed(case):
    """The variable-Γ, Div and Conv terms, ``PeriodicFlow``, an
    ``fdm.custom`` term, an immersed obstacle, ``donate`` and ``debug:
    "nan"``, which raised on a placed decomposition before, solve there and
    equal the view-based run: the same ``itr`` and 1e-12."""
    out, rep = _unported(case)
    ref, rref = _unported(case, DomainDecomposition((2, 2) if case == "periodic_flow"
                                                    else (2, 1, 1)))
    assert rep["itr"] == rref["itr"] and rep["itr"] >= 1
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-12, rtol=0)
