"""Fields whose value stays on the blocks of a placed decomposition, on the
CPU (float64): the port's counterpart of a JAX array committed to a
``NamedSharding`` (``var.VAR = jax.device_put(var(), dd.sharding(...))``).

* The five JAX tests of ``tests/test_sharding.py`` that solve Poisson,
  MG-PCG, variable-Γ and fastdiag problems under a decomposition, by name:
  the JAX package with its Field committed to the decomposition's sharding
  first (on its 8 virtual CPU devices), the port with its Field on blocks
  (``blocks.put`` on ``("cpu",) * n``): the same ``itr`` (passes for
  fastdiag) and 1e-12, the port's solution a block vector on the
  decomposition's layout, the JAX solution's sharding pinned.
* The block-wise multigrid transfers (restriction, prolongation, the FMG
  start, Γ's sampling) against the whole-tensor ones, 1e-15.
* From ``set_eq`` through the Field's update no grid-sized tensor outside
  a block's part, and ``blocks.gathers`` only at the V-cycle's hand-over.
* The Field's value through ``.numpy()``, ``x[0]``, ``apply_bcs``, the
  RHS folds and the debug ``Aop``; checkpoints, VTK and ``field_from_numpy``
  into and out of blocks; a block Field on a periodic axis, and with
  ``donate`` / ``debug``, against the view-based solve.
"""
from math import pi

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec  # noqa: E402

from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.parallel import DomainDecomposition as JDD  # noqa: E402
from pyapes_tpu.solver.fdm import FDM as JFDM  # noqa: E402
from pyapes_tpu.solver.ops import Solver as JSolver  # noqa: E402
from pyapes_tpu.testing import poisson as jpoisson  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu.variables import bcs as jbcs  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.parallel import DomainDecomposition, blocks, halo  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver, multigrid  # noqa: E402
from pyapes_tpu_torch.solver.multigrid import MGSpec  # noqa: E402
from pyapes_tpu_torch.testing import poisson as ppoisson  # noqa: E402
from pyapes_tpu_torch.utils import checkpoint, io as vio  # noqa: E402
from pyapes_tpu_torch.utils.carry import field_from_numpy  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables import bcs as pbcs  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401
from test_torch_placed import _GlobalAllocations  # noqa: E402

CPU = torch.device("cpu")


def _dd(ms):
    return DomainDecomposition(ms, devices=("cpu",) * int(np.prod(ms)))


def _grid2(n):
    return np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")


# -- the five JAX tests, committed / on blocks --------------------------------


def _problem(pkg, name, nx):
    """``(mesh, var, lhs builder, rhs builder, config)`` of the JAX test
    ``name`` in ``pkg`` ("jax" or "port"); the builders take the Field, so
    the RHS is made after the Field is committed."""
    jx = pkg == "jax"
    M = (lambda b, n: JMesh(b, None, n, dtype="double")) if jx else (
        lambda b, n: Mesh(b, None, n, device="cpu", dtype="double"))
    F, B, bcs, poi = (JField, JBox, jbcs, jpoisson) if jx else (Field, Box, pbcs, ppoisson)
    arr = (lambda a: jax.numpy.asarray(a)) if jx else torch.from_numpy
    fdm = JFDM() if jx else FDM()
    mesh = M(B[(slice(0, 1),) * len(nx)], list(nx))
    if name in ("solve", "poisson3d", "fastdiag"):
        var = F("p", 1, mesh, {"domain": poi.poisson_bcs(len(nx)), "obstacle": None})
        cfg = ({"method": "fastdiag", "tol": 1e-10, "max_it": 50} if name == "fastdiag"
               else {"method": "cg", "tol": 1e-8, "max_it": 2000})
        return var, lambda: fdm.laplacian(1.0, var), lambda: poi.poisson_rhs_nd(mesh, var), cfg
    if name == "mgcg":
        var = F("p", 1, mesh, {"domain": bcs.homogeneous_bcs(2, 0.0, "dirichlet"),
                               "obstacle": None}, init_val=0.0)
        rhs = np.random.default_rng(0).standard_normal((1, *nx))
        cfg = {"method": "cg", "tol": 1e-8, "max_it": 500, "criterion": "residual",
               "precond": "mg"}
        return var, lambda: fdm.laplacian(1.0, var), lambda: arr(rhs), cfg
    X, Y = _grid2(nx[0])  # var_gamma
    g = 1.0 + X + 2.0 * Y
    phi = np.sin(pi * X) * np.sin(pi * Y)
    rhs = (-2.0 * pi**2 * g * phi) + pi * np.cos(pi * X) * np.sin(pi * Y) \
        + 2.0 * pi * np.sin(pi * X) * np.cos(pi * Y)
    var = F("t", 1, mesh, {"domain": bcs.mixed_bcs([0.0] * 4, ["dirichlet"] * 4)}, init_val=0.0)
    cfg = {"method": "cg", "tol": 1e-9, "max_it": 300, "criterion": "residual", "precond": "mg"}
    return var, lambda: fdm.laplacian(arr(g), var), lambda: arr(rhs[None]), cfg


def _run(pkg, name, nx, ms):
    """The JAX test's solve with the Field committed to ``ms`` first (JAX:
    ``jax.device_put`` to the decomposition's sharding; the port: on
    blocks, ``blocks.put``): ``(solution, report, var)``."""
    var, lhs, rhs, cfg = _problem(pkg, name, nx)
    if pkg == "jax":
        dd = JDD(ms)
        var.VAR = jax.device_put(var(), dd.sharding(var().ndim))
        s = JSolver({"fdm": {**cfg, "report": False, "decomp": dd}})
    else:
        dd = _dd(ms)
        var.VAR = blocks.put(var(), dd)
        s = Solver({"fdm": {**cfg, "report": False, "decomp": dd}})
    s.set_eq(lhs() == rhs())
    rep = s.solve()
    assert rep["converge"], rep
    return np.asarray(var())[0], rep, var


JAX_TESTS = [("test_sharded_solve_matches_single_device", "solve", (64, 64), ms)
             for ms in [(8, 1), (1, 8), (2, 4), (4, 2)]] + [
    ("test_sharded_3d_poisson", "poisson3d", (16, 16, 16), (2, 2, 2)),
    ("test_sharded_mgcg_matches_single_device", "mgcg", (64, 64), (2, 4)),
    ("test_sharded_var_gamma_matches_single_device", "var_gamma", (64, 64), (4, 2)),
    ("test_sharded_var_gamma_matches_single_device", "var_gamma", (64, 64), (2, 4)),
    ("test_sharded_fastdiag_matches_single_device", "fastdiag", (64, 64), (8, 1)),
    ("test_sharded_fastdiag_matches_single_device", "fastdiag", (64, 64), (2, 4)),
]


@pytest.mark.parametrize("test,name,nx,ms", JAX_TESTS,
                         ids=[f"{t}-{'x'.join(map(str, ms))}" for t, _, _, ms in JAX_TESTS])
def test_block_field_matches_the_committed_jax_solve(test, name, nx, ms):
    """The port's Field on blocks against the JAX package's Field committed
    to the decomposition: the same ``itr`` (fastdiag: passes) and 1e-12;
    the solution stays a block vector on the decomposition's layout, and
    the JAX solution keeps the decomposition's sharding."""
    jout, jrep, jvar = _run("jax", name, nx, ms)
    out, rep, var = _run("port", name, nx, ms)
    assert rep["itr"] == jrep["itr"], (rep, jrep)
    np.testing.assert_allclose(out, jout, atol=1e-12, rtol=0)
    x = var()
    assert isinstance(x, blocks.BlockTensor)
    assert x.placement is blocks.layout(_dd(ms), nx, CPU)
    names = ("sx", "sy", "sz")
    assert jvar().sharding.spec == PartitionSpec(
        None, *(names[j] if m > 1 else None for j, m in enumerate(ms)))


# -- block-wise transfers ------------------------------------------------------

TRANSFER_CASES = [((4, 2, 1), (16, 16, 32), ()), ((2, 2, 2), (12, 12, 12), ()),
                  ((1, 2, 4), (16, 16, 32), ()), ((2, 2, 1), (16, 16, 16), (0, 1)),
                  ((4, 2), (32, 24), ())]


def _specs(ms, shape, paxes, kind, transfers, var_gamma=False):
    fk = tuple((kind, "dirichlet") if j not in paxes else ("dirichlet", "dirichlet")
               for j in range(len(shape)))
    kw = dict(paxes=paxes, dtype=torch.float64, face_kinds=fk, transfers=transfers,
              var_gamma=var_gamma, device="cpu", n_pre=1, n_post=1)
    return MGSpec(shape, [1.0] * len(shape), decomp=_dd(ms), **kw), \
        MGSpec(shape, [1.0] * len(shape), **kw)


@pytest.mark.parametrize("transfers", ["strided", "matrix"])
@pytest.mark.parametrize("kind", ["dirichlet", "neumann"])
@pytest.mark.parametrize("ms,shape,paxes", TRANSFER_CASES)
def test_block_transfers_equal_the_whole_ones(ms, shape, paxes, kind, transfers):
    """Restriction and prolongation between two placed levels, and Γ's
    sampling down, block by block equal ``_resize`` / ``_downsample_g`` on
    the whole tensor within 1e-15 (a cut last axis, a torus pair's strided
    wrap midpoints on cut axes among them); the rows read from other blocks
    are counted in ``halo.transfer_ghost_bytes``, and no gather is made."""
    spec, ref = _specs(ms, shape, paxes, kind, transfers)
    rng = np.random.default_rng(1)
    pairs = [(f, c) for f, c in zip(spec.shapes, spec.shapes[1:])
             if spec._placement(f) is not None and spec._placement(c) is not None]
    assert pairs
    g0, t0 = blocks.gathers, halo.transfer_ghost_bytes
    for f, c in pairs:
        for src, dst in ((f, c), (c, f)):
            x = torch.from_numpy(rng.standard_normal((1, *src)))
            out = spec._resize(blocks.scatter(x, spec._placement(src)), dst)
            assert isinstance(out, blocks.BlockTensor) and out.placement is spec._placement(dst)
            np.testing.assert_allclose(out.numpy(), ref._resize(x, dst).numpy(), atol=1e-15,
                                       rtol=0)
        g = torch.from_numpy(rng.random((1, *f)) + 1.0)
        gb = spec._resize_blocks(blocks.scatter(g, spec._placement(f)), c, spec._sample_np)
        np.testing.assert_allclose(gb.numpy()[0], ref._downsample_g(g[0], c).numpy(),
                                   atol=1e-15, rtol=0)
    assert blocks.gathers == g0
    assert (halo.transfer_ghost_bytes > t0) == any(m > 1 for m in ms)


@pytest.mark.parametrize("ms,shape,paxes", TRANSFER_CASES[:3])
def test_block_fmg_equals_the_whole_one(ms, shape, paxes):
    """The FMG start of a placed hierarchy on a block vector (transfers
    block by block, one gather at the hand-over to the lead levels per
    restriction chain and V-cycle) equals the undecomposed hierarchy's
    within 1e-15, and returns a block vector."""
    spec, ref = _specs(ms, shape, paxes, "neumann", "matrix")
    spec._prepare()
    ref._prepare()
    b = torch.from_numpy(np.random.default_rng(2).standard_normal((1, *shape)))
    g0 = blocks.gathers
    out = spec.fmg(blocks.scatter(b, spec._placement(shape)))
    n_placed = sum(spec._placement(s) is not None for s in spec.shapes)
    assert isinstance(out, blocks.BlockTensor)
    # the restriction chain's hand-over, and one per V-cycle of a placed level
    assert blocks.gathers - g0 == (1 + n_placed if n_placed < len(spec.shapes) else 0)
    np.testing.assert_allclose(out.numpy(), ref.fmg(b).numpy(), atol=1e-15, rtol=0)


def test_block_level_constants_are_built_per_block():
    """The mask, the row scales, the surgered diagonal and the parity of a
    placed level are block vectors built on the blocks, equal to the whole
    level's, with no tensor of a placed level's size made for them (16
    blocks: a block of the finest level is smaller than the next level)."""
    ms, shape = (4, 4, 1), (16, 16, 32)
    spec, ref = _specs(ms, shape, (), "neumann", "matrix")
    spec.smoother = ref.smoother = "rbgs"
    numel = int(np.prod(spec.shapes[1]))
    mode = _GlobalAllocations(numel)
    with mode:
        spec._prepare()
    assert mode.hits == []
    ref._prepare()
    for s in spec.shapes[:2]:
        for name in ("_mask", "_dfield", "_diag", "_parity"):
            got, want = getattr(spec, name)(s), getattr(ref, name)(s)
            assert isinstance(got, blocks.BlockTensor), name
            np.testing.assert_array_equal(got.numpy(), np.broadcast_to(want.numpy(), got.shape))


# -- the solve: no grid-sized tensor, gathers only at the hand-over ------------

CG = {"method": "cg", "tol": 1e-10, "max_it": 600, "criterion": "residual"}
MG = {**CG, "precond": "mg", "mg_opts": {"n_pre": 1, "n_post": 1}}
PROBE = {"cg": CG, "bicgstab": {**CG, "method": "bicgstab"}, "mg": MG,
         "mg_fmg": {**MG, "mg_opts": {"n_pre": 2, "n_post": 2, "fmg": True}},
         "fastdiag": {"method": "fastdiag", "tol": 1e-10, "max_it": 50},
         "cg_fd": {**CG, "precond": "fd"}, "darcy": MG}


def _block_problem(nx, ms, seed=0, kinds=None, gamma=False, dtype="double"):
    """A Laplacian (``gamma``: a variable Γ on blocks) on the unit box whose
    Field, RHS and Γ are block vectors of ``ms``, built from host arrays
    straight into the blocks."""
    mesh = Mesh(Box[(slice(0, 1),) * len(nx)], None, list(nx), device="cpu", dtype=dtype)
    bcs = (pbcs.homogeneous_bcs(len(nx), 0.0, "dirichlet") if kinds is None
           else pbcs.mixed_bcs([0.0] * len(kinds), kinds))
    dd = _dd(ms)
    var = Field("p", 1, mesh, {"domain": bcs, "obstacle": None},
                init_val=blocks.put(torch.zeros((1, *nx), dtype=mesh.dtype.float), dd))
    rhs = blocks.put(torch.from_numpy(np.random.default_rng(seed).standard_normal((1, *nx))), dd)
    coeff = 1.0
    if gamma:
        x = np.linspace(0, 1, nx[0]).reshape((-1,) + (1,) * (len(nx) - 1))
        coeff = blocks.put(torch.from_numpy(1.0 + x + np.zeros(nx))[None], dd)
    return mesh, var, rhs, coeff, dd


@pytest.mark.parametrize("method", list(PROBE))
def test_block_field_solve_allocates_nothing_grid_sized(method):
    """From ``set_eq`` through the Field's update a solve on a block Field
    (and a block RHS; Darcy: a block Γ) makes no plain tensor of the grid's
    size (MG: of its finest level on the lead, the hand-over's) and gathers
    only at the V-cycle's hand-over (and Γ's, once); the solution is a block
    vector on the Field's blocks."""
    nx, ms = (32, 32, 32), (4, 4, 1)
    _, var, rhs, coeff, dd = _block_problem(nx, ms, gamma=method == "darcy")
    lay = var().placement
    s = Solver({"fdm": {**PROBE[method], "report": False}})  # the Field's decomposition
    mg = method.startswith("mg") or method == "darcy"
    # MG: nothing of the second (placed) level's size either; the first
    # level's blocks with their halos (10 x 10 x 32) are smaller, and so are
    # the levels off the blocks (4^3)
    numel = int(np.prod(nx)) // 8 if mg else int(np.prod(nx))
    c0 = (blocks.gathers, multigrid.vcycles, multigrid.fmg_gathers, multigrid.gamma_gathers,
          blocks.operand_scatters)
    mode = _GlobalAllocations(numel)
    with mode:
        s.set_eq(FDM().laplacian(coeff, var) == rhs)
        rep = s.solve()
    gathers, cycles, fmg, gam, scat = (a - b for a, b in zip(
        (blocks.gathers, multigrid.vcycles, multigrid.fmg_gathers, multigrid.gamma_gathers,
         blocks.operand_scatters), c0))
    assert rep["converge"] and mode.hits == []
    assert isinstance(var(), blocks.BlockTensor) and var().placement is lay
    assert gathers == (cycles + fmg + gam if mg else 0) and scat == 0
    assert gam == (1 if method == "darcy" else 0)
    if mg:
        assert cycles == rep["itr"] + 1


MIXED = ["neumann", "dirichlet", "symmetry", "dirichlet", "dirichlet", "dirichlet"]
# the variable-Γ Laplacian on Dirichlet faces (its Neumann rows are
# nonsymmetric: BiCGSTAB, in test_torch_darcy.py)
EQUAL_CASES = [(m, (4, 2, 1), (16, 16, 32), None) for m in ("cg", "mg", "fastdiag", "cg_fd",
                                                             "darcy")] + \
    [(m, (2, 2, 2), (12, 12, 12), MIXED) for m in ("cg", "mg", "fastdiag", "cg_fd")] + \
    [(m, (1, 2, 4), (16, 16, 32), None) for m in ("cg", "mg", "fastdiag", "cg_fd", "darcy")]


@pytest.mark.parametrize("method,ms,nx,kinds", EQUAL_CASES)
def test_block_field_equals_the_whole_field(method, ms, nx, kinds):
    """A Field on blocks takes the ``itr`` and, to 1e-12, the solution of the
    same solve with its value whole on the lead (scattered at entry and
    gathered at exit), on the same placed decomposition; mixed Neumann and
    Symmetry faces and a cut last axis among them."""
    out = []
    for on_blocks in (True, False):
        _, var, rhs, coeff, dd = _block_problem(nx, ms, 3, kinds, gamma=method == "darcy")
        if not on_blocks:
            var.VAR, rhs = var().numpy(), torch.from_numpy(rhs.numpy())
            coeff = torch.from_numpy(coeff.numpy()[0]) if method == "darcy" else coeff
        s = Solver({"fdm": {**PROBE[method], "report": False, "decomp": dd}})
        s.set_eq(FDM().laplacian(coeff, var) == rhs)
        rep = s.solve()
        assert isinstance(var(), blocks.BlockTensor) == on_blocks
        out.append((var().numpy(), rep["itr"]))
    assert out[0][1] == out[1][1]
    np.testing.assert_allclose(out[0][0], out[1][0], atol=1e-12, rtol=0)


def test_block_field_transient_and_advection_steps():
    """A Ddt + Div (a velocity field on blocks) + Laplacian equation, two
    BiCGSTAB steps of a block Field with BDF2 history (``save_old``): the
    history, the RHS and the advector stay on blocks and the steps equal
    the whole Field's, the same ``itr`` and 1e-12."""
    nx, ms = (16, 12, 8), (2, 2, 1)
    outs = []
    for on_blocks in (True, False):
        mesh = Mesh(Box[0:1, 0:1, 0:1], None, list(nx), device="cpu", dtype="double")
        kinds = ["dirichlet", "neumann", "dirichlet", "dirichlet", "dirichlet", "dirichlet"]
        var = Field("c", 1, mesh, {"domain": pbcs.mixed_bcs([1.0, 0.3, 0, 0, 0, 0], kinds),
                                   "obstacle": None}, init_val=0.0)
        u = torch.from_numpy(0.5 + np.random.default_rng(4).random((1, *nx)))
        dd = _dd(ms)
        if on_blocks:
            var.VAR, u = blocks.put(var(), dd), blocks.put(u, dd)
        var.set_time(0.01)
        itrs = []
        fdm = FDM({"div": {"limiter": "upwind", "edge": False}})
        for _ in range(2):
            var.save_old()
            s = Solver({"fdm": {"method": "bicgstab", "tol": 1e-12, "max_it": 400,
                                "report": False, "decomp": dd}})
            s.set_eq(fdm.ddt(var, scheme="bdf2") + fdm.div(u, var) - fdm.laplacian(0.1, var)
                     == 0.0)
            itrs.append(s.solve()["itr"])
            var.update_time()
        assert isinstance(var(), blocks.BlockTensor) == on_blocks
        assert isinstance(var.VARo, blocks.BlockTensor) == on_blocks
        outs.append((var().numpy(), itrs))
    assert outs[0][1] == outs[1][1]
    np.testing.assert_allclose(outs[0][0], outs[1][0], atol=1e-12, rtol=0)


# -- the Field's value and its utilities on blocks -----------------------------


def _field(nx=(8, 8, 12), ms=(2, 2, 1), vdim=2, kinds=None, vals=None):
    mesh = Mesh(Box[(slice(0, 1),) * len(nx)], None, list(nx), device="cpu", dtype="double")
    kinds = kinds or ["dirichlet"] * (2 * len(nx))
    vals = vals or [0.0] * (2 * len(nx))
    var = Field("q", vdim, mesh, {"domain": pbcs.mixed_bcs(vals, kinds), "obstacle": None},
                init_val=0.0)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((vdim, *nx)))
    return mesh, var, x, _dd(ms)


def test_host_reads_of_a_block_field():
    """``.numpy()``, ``np.asarray``, ``.cpu()``, ``.item()``, ``x[0]`` and
    ``x[0:1]`` of a block value equal the gathered value; the host reads
    count in ``blocks.host_gathers`` and never in ``blocks.gathers``; a
    component write ``var[1] = v`` and ``set_var_tensor`` keep the blocks."""
    _, var, x, dd = _field()
    var.VAR = blocks.put(x, dd)
    v = var()
    h0, g0 = blocks.host_gathers, blocks.gathers
    np.testing.assert_array_equal(v.numpy(), x.numpy())
    np.testing.assert_array_equal(np.asarray(v), x.numpy())
    c = v.cpu()
    assert torch.equal(c, x) and not isinstance(c, blocks.BlockTensor)
    one = blocks.BlockTensor([torch.full((1, 1, 1, 1), 3.5, dtype=x.dtype)] * 4, v.placement,
                             (1, 1, 1, 1))  # length 1 on every grid axis: one value
    assert one.item() == 3.5
    assert blocks.host_gathers - h0 == 4 and blocks.gathers == g0
    for sel in (var[0], v[1], v[0:1]):
        assert isinstance(sel, blocks.BlockTensor)
    np.testing.assert_array_equal(var[1].numpy(), x[1].numpy())
    np.testing.assert_array_equal(v[0:1].numpy(), x[0:1].numpy())
    var[1] = 2.0 * x[0]
    var.set_var_tensor(torch.ones(x.shape[1:], dtype=x.dtype), insert=0)
    want = torch.stack([torch.ones_like(x[0]), 2.0 * x[0]])
    assert isinstance(var(), blocks.BlockTensor) and var().placement is v.placement
    np.testing.assert_array_equal(var().numpy(), want.numpy())
    assert blocks.gathers == g0


def test_apply_bcs_and_rhs_folds_on_blocks():
    """``Field.apply_bcs`` writes each face's values into its edge blocks, and
    the Laplacian's nonzero-Neumann RHS fold (``blocks.add_at``) lands in
    the right rows of the right blocks: both equal the whole Field's."""
    kinds = ["neumann", "dirichlet", "dirichlet", "neumann", "dirichlet", "dirichlet"]
    vals = [0.7, 1.5, -0.25, 2.0, 0.5, 0.0]
    mesh, var, x, dd = _field(vdim=1, kinds=kinds, vals=vals)
    var.VAR = x[:1].clone()
    want = var.apply_bcs()().clone()
    rhs_want = (FDM().laplacian(1.0, var) == 0.0)
    s = Solver({"fdm": {}})
    s.set_eq(rhs_want)
    rhs_whole = s.rhs.clone()
    var.VAR = blocks.put(x[:1].clone(), dd)
    g0 = blocks.gathers
    got = var.apply_bcs()()
    assert isinstance(got, blocks.BlockTensor)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    s.set_eq(FDM().laplacian(1.0, var) == 0.0)
    assert isinstance(s.rhs, blocks.BlockTensor) and blocks.gathers == g0
    np.testing.assert_array_equal(s.rhs.numpy(), rhs_whole.numpy())
    np.testing.assert_array_equal(blocks.take(got, (0, slice(None), -2, 3)).numpy(),
                                  want[0, :, -2, 3].numpy())


@pytest.mark.parametrize("term", ["laplacian", "var_gamma", "div", "conv", "ddt"])
def test_debug_aop_on_blocks(term):
    """``Solver.Aop`` (the debug interface) of a block Field, Γ, advector
    or history on blocks too, equals the whole Field's, through one counted
    gather of the value and one of each block operand, and a block vector
    back."""
    mesh, var, x, dd = _field(vdim=1)
    fdm = FDM({"div": {"limiter": "upwind", "edge": False}})
    g = torch.from_numpy(1.0 + np.random.default_rng(6).random(mesh.nx))
    u = torch.from_numpy(np.random.default_rng(7).random((1, *mesh.nx)))
    uc = torch.from_numpy(np.random.default_rng(8).random((3, *mesh.nx)))
    out = []
    for on_blocks in (False, True):
        put = (lambda t: blocks.put(t, dd)) if on_blocks else (lambda t: t)
        var.VAR = put(x[:1].clone())
        if term == "ddt":
            var.set_time(0.1)
            var.save_old()
            var.VAR = var() * 0.5
        eq = {"laplacian": lambda: fdm.laplacian(1.0, var),
              "var_gamma": lambda: fdm.laplacian(put(g[None]), var),
              "div": lambda: fdm.div(put(u), var),
              "conv": lambda: fdm.conv(put(uc), var),
              "ddt": lambda: fdm.ddt(var) - fdm.laplacian(1.0, var)}[term]()
        s = Solver({"fdm": {}})
        s.set_eq(eq == 0.0)
        g0 = blocks.gathers
        a = s.Aop(var)
        assert isinstance(a, blocks.BlockTensor) == on_blocks
        assert blocks.gathers - g0 == (1 + (term != "laplacian") if on_blocks else 0)
        out.append(a.numpy())
    np.testing.assert_array_equal(out[1], out[0])


def test_placed_diff_diag_equals_the_whole_one():
    """The variable-Γ diagonal of a placed level (the rbgs and Chebyshev
    smoothers') built block by block from the halo-extended Γ equals the
    whole Γ's on the rows the solver keeps, isotropic and stacked, with
    Neumann surgery."""
    from pyapes_tpu_torch.ops.stencil import diff_diag

    dd = _dd((2, 2, 1))
    rng = np.random.default_rng(8)
    surgery = (("neumann", "none"), ("none", "neumann"), ("none", "none"))
    for gdim in (1, 3):
        g = torch.from_numpy(1.0 + rng.random((gdim, 8, 8, 12)))
        got = halo.placed_diff_diag(blocks.put(g, dd), [4.0, 9.0, 16.0], surgery, "harmonic")
        want = diff_diag(g[0] if gdim == 1 else g, [4.0, 9.0, 16.0], surgery, "harmonic")
        inner = (slice(None),) + (slice(1, -1),) * 3
        assert isinstance(got, blocks.BlockTensor)
        np.testing.assert_allclose(got.numpy()[inner], want.numpy()[inner], atol=1e-13, rtol=0)


def test_checkpoint_round_trip_into_blocks(tmp_path):
    """``save`` of a block Field (through the host gather) and ``load`` into a
    block Field restore every level bit for bit into the same blocks; the
    file equals the whole Field's; ``save_orbax``/``load_orbax`` too."""
    mesh, var, x, dd = _field()
    whole = var.copy()
    whole._VAR, whole._VARo = x.clone(), 2.0 * x
    var.VAR, var.VARo = blocks.put(x, dd), blocks.put(2.0 * x, dd)
    var._n_hist = whole._n_hist = 1
    checkpoint.save(str(tmp_path / "b"), {"q": var})
    checkpoint.save(str(tmp_path / "w"), {"q": whole})
    with np.load(tmp_path / "b.npz") as a, np.load(tmp_path / "w.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    for save, load in ((checkpoint.save, checkpoint.load),
                       (checkpoint.save_orbax, checkpoint.load_orbax)):
        save(str(tmp_path / "c"), {"q": var})
        _, fresh, _, _ = _field()
        fresh.VAR = blocks.put(torch.zeros_like(x), dd)
        lay = fresh().placement
        load(str(tmp_path / "c"), {"q": fresh})
        for level in ("VAR", "VARo"):
            got, want = getattr(fresh, level), getattr(var, level)
            assert isinstance(got, blocks.BlockTensor) and got.placement is lay
            for p, q in zip(got.parts, want.parts):
                assert torch.equal(p, q)


def test_write_vtk_of_a_block_field(tmp_path):
    """``write_vtk`` of a block Field writes the bytes of the whole Field's."""
    mesh, var, x, dd = _field(vdim=1)
    a = vio.write_vtk(str(tmp_path / "w"), mesh, {"q": x[:1]})
    b = vio.write_vtk(str(tmp_path / "b"), mesh, {"q": blocks.put(x[:1], dd)})
    assert open(a, "rb").read() == open(b, "rb").read()


def test_field_from_numpy_into_blocks():
    """``field_from_numpy`` into a block Field puts the arrays (values and
    history) straight into its blocks."""
    _, var, x, dd = _field()
    var.VAR = blocks.put(torch.zeros_like(x), dd)
    lay = var().placement
    field_from_numpy(var, x.numpy(), varo=2.0 * x.numpy())
    for level, want in (("VAR", x), ("VARo", 2.0 * x)):
        got = getattr(var, level)
        assert isinstance(got, blocks.BlockTensor) and got.placement is lay
        assert torch.equal(got.cpu(), want)
    assert var.n_hist == 1


def test_block_field_on_a_periodic_axis_solves():
    """A Field on blocks with a periodic axis (which raised before) solves
    on the torus of its blocks (the reduction a per-block slice, the seam
    re-appended), keeps the solution there and equals the view-based run:
    the same ``itr`` and 1e-12; nothing falls back to the lead device."""
    bc = pbcs.mixed_bcs([None, None, 0, 0], ["periodic", "periodic", "dirichlet", "dirichlet"])
    rhs = np.random.default_rng(4).standard_normal((1, 17, 16))
    out = []
    for dd in (_dd((1, 2)), DomainDecomposition((1, 2))):
        mesh = Mesh(Box[0:1, 0:1], None, [17, 16], device="cpu", dtype="double")
        var = Field("p", 1, mesh, {"domain": bc, "obstacle": None}, init_val=0.0)
        if dd.placed:
            var.VAR = blocks.put(var(), dd)
        s = Solver({"fdm": {**CG, "decomp": dd}})
        s.set_eq(FDM().laplacian(1.0, var) == torch.from_numpy(rhs))
        g0 = blocks.gathers
        rep = s.solve()
        assert blocks.gathers == g0 and isinstance(var(), blocks.BlockTensor) == dd.placed
        out.append((var().cpu().numpy(), rep))
    (x, rep), (ref, rref) = out
    assert rep["converge"] and rep["itr"] == rref["itr"]
    np.testing.assert_allclose(x, ref, atol=1e-12, rtol=0)


def test_block_field_on_a_view_based_decomposition_raises():
    """A Field on blocks solves on a placed decomposition (its own when the
    config names none); a view-based one, which needs the whole grid on one
    device, raises rather than gathering."""
    _, var, rhs, _, _ = _block_problem((16, 8, 8), (2, 1, 1))
    s = Solver({"fdm": {**CG, "decomp": DomainDecomposition((2, 1, 1))}})
    s.set_eq(FDM().laplacian(1.0, var) == rhs)
    g0 = blocks.gathers
    with pytest.raises(ValueError, match="placed decomposition"):
        s.solve()
    assert blocks.gathers == g0


@pytest.mark.parametrize("case", ["donate", "debug_nan"])
def test_block_field_with_a_later_option_solves(case):
    """A block Field with ``donate`` or ``debug: "nan"`` (options that raised
    on blocks before) solves on its blocks, keeps the solution there (with
    ``donate`` in its own blocks' storage) and equals the view-based run of
    the same problem: the same ``itr`` and 1e-12; nothing is gathered."""
    opt = {"donate": {"donate": True}, "debug_nan": {"debug": "nan"}}[case]
    _, var, rhs, _, dd = _block_problem((16, 8, 8), (2, 1, 1))
    ptrs = [p.data_ptr() for p in var().parts]
    s = Solver({"fdm": {**CG, **opt}})
    s.set_eq(FDM().laplacian(1.0, var) == rhs)
    g0 = blocks.gathers
    rep = s.solve()
    assert blocks.gathers == g0 and isinstance(var(), blocks.BlockTensor)
    assert ([p.data_ptr() for p in var().parts] == ptrs) == (case == "donate")
    _, ref, rhs2, _, _ = _block_problem((16, 8, 8), (2, 1, 1))
    ref.VAR = ref().cpu()
    s2 = Solver({"fdm": {**CG, **opt, "decomp": DomainDecomposition((2, 1, 1))}})
    s2.set_eq(FDM().laplacian(1.0, ref) == rhs2.cpu())
    rref = s2.solve()
    assert rep["converge"] and rep["itr"] == rref["itr"]
    np.testing.assert_allclose(var().numpy(), ref().numpy(), atol=1e-12, rtol=0)


def test_put_build_and_repartition_of_a_block_value():
    """``blocks.put`` from a host array, ``blocks.build`` block by block,
    and a solve of a Field on one cut with a decomposition of another: the
    value is moved (``blocks.repartition``, counted), and the solution stays
    on the solve's cut."""
    nx = (16, 16, 8)
    dd, other = _dd((4, 1, 1)), _dd((1, 2, 2))
    x = np.random.default_rng(7).standard_normal((1, *nx))
    a = blocks.put(x, dd)
    b = blocks.build(a.placement, lambda sl, dev: torch.from_numpy(
        x[(slice(None), *sl)].copy()).to(dev))
    assert all(torch.equal(p, q) for p, q in zip(a.parts, b.parts))
    mesh = Mesh(Box[0:1, 0:1, 0:1], None, list(nx), device="cpu", dtype="double")
    var = Field("p", 1, mesh, {"domain": pbcs.homogeneous_bcs(3, 0.0, "dirichlet"),
                               "obstacle": None}, init_val=torch.zeros_like(a))
    ref = Field("p", 1, mesh, {"domain": pbcs.homogeneous_bcs(3, 0.0, "dirichlet"),
                               "obstacle": None}, init_val=0.0)
    r0 = blocks.repartitions
    reps = []
    for f in (var, ref):
        s = Solver({"fdm": {**CG, "decomp": other, "report": False}})
        s.set_eq(FDM().laplacian(1.0, f) == torch.from_numpy(x))
        reps.append(s.solve()["itr"])
    assert blocks.repartitions - r0 >= 1
    assert var().placement is blocks.layout(other, nx, CPU)
    assert reps[0] == reps[1]
    np.testing.assert_allclose(var().numpy(), ref().numpy(), atol=1e-12, rtol=0)
