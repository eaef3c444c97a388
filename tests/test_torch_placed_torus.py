"""Block Fields on periodic axes and ``PeriodicFlow`` with its state on
blocks (placed decompositions on ``("cpu",) * n``, float64).

A periodic axis of ``2^k + 1`` nodes stores the duplicate seam node at both
ends: its torus of ``2^k`` divides into the blocks, the Field's grid does
not. A Field on such an axis is cut as its torus, the seam plane held by
the last block along it (``blocks.Layout.seam``); the torus reduction of a
solve is then a view block by block and the seam's re-append one face
copy. ``torch.roll``, ``torch.stack``, ``torch.cat`` of a leading axis and
the mean run block by block, so ``PeriodicFlow``'s explicit glue (the
strain rate, the viscosity laws, the skew split, the projection) runs on
the blocks and its Fields stay there across steps.

* The layout, the reduction view, ``append_seam``, the ring roll, the
  leading stack and cat, the mean and the periodic face copy against the
  whole tensor's, bit for bit (the mean to rounding).
* JAX ``test_sharding.py::test_sharded_periodic_flow_taylor_green`` with
  the port's state on placed (2, 4) blocks: the whole-state placed run's
  ``itr`` and fields (1e-12), the JAX decomposed and single-device runs
  to the JAX test's 1e-9.
* The 17^3 Smagorinsky LES and the fused placed LES of
  ``test_torch_placed_graphs.py`` with their state on blocks against the
  same runs with whole state: the same ``itr``, 1e-12; no gather in a
  step and no grid-sized allocation.
* JAX ``test_obstacle.py::test_dynamic_obstacle_with_periodic_axis`` with
  its Field on blocks of the torus.
"""
from math import pi

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyapes_tpu.models as jmodels  # noqa: E402
import pyapes_tpu_torch.models as pmodels  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.models import PeriodicFlow, smagorinsky_viscosity  # noqa: E402
from pyapes_tpu_torch.parallel import DomainDecomposition, blocks  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.solver.ops import solve_log  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables import bcs as pbcs  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401
from test_torch_placed import _GlobalAllocations  # noqa: E402
from test_torch_placed_options import JAX, PLACED, PORT, dynamic  # noqa: E402

CPU = torch.device("cpu")


class _GridAllocations(_GlobalAllocations):
    """``_GlobalAllocations`` of tensors with a grid's rank (a solve's
    residual history, a 1-D buffer of ``max_it`` entries, is no grid)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        n = len(self.hits)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if len(self.hits) > n and all(t.dim() < 2 for t in torch.utils._pytree.tree_leaves(out)
                                      if isinstance(t, torch.Tensor)):
            del self.hits[n:]
        return out


def _dd(ms):
    return DomainDecomposition(ms, devices=("cpu",) * int(np.prod(ms)))


# -- the layout and the block-wise operations --------------------------------


def test_seam_layout_and_the_torus_view():
    """A (2, 4) cut of 17 x 33 nodes is the torus' (16 x 32) with the last
    block along each axis one row longer; ``x[:, :-1, :-1]`` is a view on
    the torus' layout (writes reach the blocks) and ``append_seam`` puts
    the seam back, one face copied from the first block along the axis."""
    dd = _dd((2, 4))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 17, 33)))
    xb = blocks.put(x, dd)
    lay = xb.placement
    assert lay.seam == (0, 1)
    assert [tuple(s.stop - s.start for s in sl) for _, sl, _ in lay.blocks] == [
        (8, 8), (8, 8), (8, 8), (8, 9), (9, 8), (9, 8), (9, 8), (9, 9)]
    red = xb[:, :-1, :-1]
    assert isinstance(red, blocks.BlockTensor)
    assert red.placement is blocks.layout(dd, (16, 32), CPU) and red.placement.seam == ()
    assert torch.equal(red.cpu(), x[:, :-1, :-1])
    assert all(r.untyped_storage().data_ptr() == p.untyped_storage().data_ptr()
               for r, p in zip(red.parts, xb.parts))
    y = blocks.append_seam(blocks.append_seam(red, 1), 2)
    want = torch.cat([x[:, :-1, :-1], x[:, :1, :-1]], 1)
    want = torch.cat([want, want[:, :, :1]], 2)
    assert y.placement is lay and torch.equal(y.cpu(), want)
    with pytest.raises(ValueError, match="does not divide"):
        blocks.put(torch.zeros(1, 17, 34), dd)


@pytest.mark.parametrize("shift", [1, -1, 2, -3, 9])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_roll_of_a_block_vector_is_the_whole_roll(axis, shift):
    """``torch.roll`` along a cut axis (blocks thinner than the shift
    among them), an uncut axis and the leading axis equals the whole
    tensor's roll, with no gather."""
    dd = _dd((4, 2))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, 8, 5)))
    xb = blocks.scatter(x, blocks.layout(dd, (16, 8, 5), CPU))
    g0 = blocks.gathers
    out = torch.roll(xb, shift, 1 + axis if axis < 2 else 0)
    assert isinstance(out, blocks.BlockTensor) and blocks.gathers == g0
    assert torch.equal(out.cpu(), torch.roll(x, shift, 1 + axis if axis < 2 else 0))
    both = torch.roll(xb, (shift, -shift), (1, 2))
    assert torch.equal(both.cpu(), torch.roll(x, (shift, -shift), (1, 2)))


def test_stack_cat_mean_and_the_periodic_face_of_block_vectors():
    """The leading stack and cat block by block, the mean from per-block
    sums (to rounding), and a periodic Field's ``apply_bcs`` on a seam
    layout: the first block's first plane copied onto the seam."""
    dd = _dd((2, 2))
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.standard_normal((1, 17, 17))) for _ in range(2))
    ab, bb = blocks.put(a, dd), blocks.put(b, dd)
    g0 = blocks.gathers
    st = torch.stack([ab[0], bb[0]])
    assert isinstance(st, blocks.BlockTensor) and torch.equal(st.cpu(), torch.stack([a[0], b[0]]))
    ct = torch.cat([ab, bb], 0)
    assert torch.equal(ct.cpu(), torch.cat([a, b], 0))
    np.testing.assert_allclose(float(torch.mean(ab)), float(torch.mean(a)), rtol=1e-15, atol=0)
    assert blocks.gathers == g0
    mesh = Mesh(Box[0:1, 0:1], None, [17, 17], device="cpu", dtype="double")
    per = pbcs.homogeneous_bcs(2, None, "periodic")
    var = Field("p", 1, mesh, {"domain": per, "obstacle": None}, init_val=ab)
    ref = Field("p", 1, mesh, {"domain": per, "obstacle": None}, init_val=a)
    var.apply_bcs()
    ref.apply_bcs()
    assert isinstance(var(), blocks.BlockTensor) and torch.equal(var().cpu(), ref())


def test_block_field_solves_on_the_torus_of_its_blocks():
    """A CG solve of a Field on (2, 2) blocks of 17 x 17 nodes with a
    periodic x axis (the seam layout along x): the torus reduction a view,
    no gather, the solution back on the Field's blocks; the whole Field's
    placed solve's ``itr`` and solution (1e-12)."""
    bc = pbcs.mixed_bcs([None, None, 0, 0], ["periodic", "periodic", "dirichlet", "dirichlet"])
    rhs = np.random.default_rng(3).standard_normal((1, 17, 16))
    dd = _dd((2, 2))
    out = []
    for on_blocks in (True, False):
        mesh = Mesh(Box[0:1, 0:1], None, [17, 16], device="cpu", dtype="double")
        var = Field("p", 1, mesh, {"domain": bc, "obstacle": None}, init_val=0.0)
        r = torch.from_numpy(rhs)
        if on_blocks:
            var.VAR = blocks.put(var(), dd)
            r = blocks.put(r, dd)
        s = Solver({"fdm": {"method": "cg", "tol": 1e-10, "max_it": 500,
                            "criterion": "residual", "decomp": dd}})
        s.set_eq(FDM().laplacian(1.0, var) == r)
        g0 = blocks.gathers
        rep = s.solve()
        assert blocks.gathers == g0
        assert isinstance(var(), blocks.BlockTensor) == on_blocks
        out.append((var().cpu(), rep))
    (x, rep), (ref, rref) = out
    assert rep["converge"] and rep["itr"] == rref["itr"]
    np.testing.assert_allclose(x.numpy(), ref.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(x[:, 0], x[:, -1])


# -- PeriodicFlow with its state on blocks -----------------------------------


def _taylor_green(P, models, decomp, on_blocks=False):
    """``test_sharded_periodic_flow_taylor_green``'s run (33^2, 32^2 on the
    torus, tol 1e-10, 5 steps of 2e-3): ``(u, v, p, itr per solve)``; with
    ``on_blocks`` the state is put on the blocks after the set-up, and a
    step is probed for gathers and grid-sized allocations."""
    mesh = P.Mesh(P.Box[(slice(0, 1),) * 2], None, [33, 33])
    cfg = {"tol": 1e-10}
    if decomp is not None:
        cfg["decomp"] = P.DD(decomp)
    model = models.PeriodicFlow(mesh, nu=0.01, config=cfg)
    X, Y = np.meshgrid(np.linspace(0, 1, 33), np.linspace(0, 1, 33), indexing="ij")
    k = 2 * pi
    model.set_velocity(P.arr(-np.cos(k * X) * np.sin(k * Y)), P.arr(np.sin(k * X) * np.cos(k * Y)))
    if on_blocks:
        model.put_state(cfg["decomp"])
    itr = []
    for solver in (model.mom_solver, model.p_solver):
        real = solver.solve

        def solve(real=real):
            rep = real()
            itr.append(rep["itr"])
            return rep

        solver.solve = solve
    g0 = blocks.gathers
    model.run(2e-3, 4)
    if on_blocks:
        mode = _GridAllocations(33 * 33)
        with mode:
            model.step(2e-3)
        assert mode.hits == [] and blocks.gathers == g0
        assert all(isinstance(f(), blocks.BlockTensor) for f in model.state_fields())
    else:
        model.step(2e-3)
    return [np.asarray(f()[0]) for f in (model.u, model.v, model.p)] + [itr]


def test_sharded_periodic_flow_taylor_green():
    """The JAX test with the port's state on placed (2, 4) blocks: no gather
    and no grid-sized allocation in a step, the whole-state placed run's
    passes and fields (1e-12), the JAX decomposed and single-device runs to
    the JAX test's 1e-9 with the same passes."""
    placed = _taylor_green(PLACED, pmodels, (2, 4), on_blocks=True)
    whole = _taylor_green(PLACED, pmodels, (2, 4))
    jdec = _taylor_green(JAX, jmodels, (2, 4))
    jref = _taylor_green(JAX, jmodels, None)
    assert placed[3] == whole[3] == jdec[3] == jref[3] and len(placed[3]) == 15
    for a, b, c, d, name in zip(placed[:3], whole[:3], jdec[:3], jref[:3], ("u", "v", "p")):
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=0, err_msg=name)
        np.testing.assert_allclose(a, c, atol=1e-9, rtol=1e-9, err_msg=name)
        np.testing.assert_allclose(a, d, atol=1e-9, rtol=1e-9, err_msg=name)


def _les3d(on_blocks):
    """3 steps of the Smagorinsky TGV-3D LES (17^3, 16^3 on the torus) on
    placed (2, 2, 1) blocks, the state whole or on the blocks: ``(itr per
    solve, the state's values, the kinetic energy)``; the third step probed
    for gathers and grid-sized allocations."""
    L, nu = 2 * pi, 1.0 / 1600.0
    dd = _dd((2, 2, 1))
    mesh = Mesh(Box[0:L, 0:L, 0:L], None, [17] * 3, device="cpu", dtype="double")
    model = PeriodicFlow(mesh, nu=nu, config={"decomp": dd},
                         mu_strain_fn=smagorinsky_viscosity(nu, mesh, cs=0.17))
    X, Y, Z = mesh.X, mesh.Y, mesh.Z
    model.set_velocity(torch.sin(X) * torch.cos(Y) * torch.cos(Z),
                       -torch.cos(X) * torch.sin(Y) * torch.cos(Z), torch.zeros_like(X))
    if on_blocks:
        model.put_state(dd)
    dt = 0.2 * L / 16
    with solve_log() as reports:
        model.run(dt, 2)
        g0 = blocks.gathers
        mode = _GridAllocations(17**3)
        with mode:
            model.step(dt)
    if on_blocks:
        assert mode.hits == [] and blocks.gathers == g0
        assert isinstance(model._nu_field, blocks.BlockTensor)
    return ([r["itr"] for r in reports], [f().cpu() for f in model.state_fields()],
            float(model.kinetic_energy()))


def test_placed_les_with_its_state_on_blocks():
    """The 17^3 LES with its state on blocks: the strain rate, the viscosity
    law and the transpose stress on the blocks, no gather and no grid-sized
    allocation in a step, the whole-state placed run's ``itr`` per solve and
    fields (1e-12), the same kinetic energy (1e-12 relative)."""
    blk, whole = _les3d(True), _les3d(False)
    assert blk[0] == whole[0] and len(blk[0]) == 12
    for a, b in zip(blk[1], whole[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(blk[2], whole[2], rtol=1e-12, atol=0)


def _fused_les(on_blocks):
    """``test_torch_placed_graphs.py``'s fused placed LES (33^2 on (2, 2)
    blocks, 5 steps) with the state whole or on the blocks."""
    from test_torch_placed_graphs import LES_DT, LES_N, LES_NU, LES_STEPS

    L = 2 * pi
    dd = _dd((2, 2))
    mesh = Mesh(Box[0:L, 0:L], None, [LES_N] * 2, device="cpu", dtype="double")
    m = PeriodicFlow(mesh, nu=LES_NU, config={"decomp": dd},
                     mu_strain_fn=smagorinsky_viscosity(LES_NU, mesh, cs=0.17))
    X, Y = mesh.grid
    m.set_velocity(torch.sin(X) * torch.cos(Y), -torch.cos(X) * torch.sin(Y))
    if on_blocks:
        m.put_state(dd)
    m.run(LES_DT, 2, fused=True)
    itr = []
    g0 = blocks.gathers
    for _ in range(LES_STEPS - 2):
        m.fused_runner().step(LES_DT)
        itr += [int(r["itr"]) for r in m.fused_runner().reports]
    assert blocks.gathers == g0
    m._refresh_strain_viscosity()
    return m, itr


def test_fused_placed_les_with_its_state_on_blocks():
    """The fused placed LES with its state on blocks: the state stays on the
    blocks through the runner's steps, the whole-state fused run's ``itr``
    and fields (1e-12)."""
    (mb, ib), (mw, iw) = _fused_les(True), _fused_les(False)
    assert ib == iw and len(ib) == 9
    for a, b in zip(mb.state_fields(), mw.state_fields()):
        assert isinstance(a(), blocks.BlockTensor), a.name
        np.testing.assert_allclose(a().cpu().numpy(), b().numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(mb._nu_field.cpu().numpy(), mw._nu_field.numpy(), atol=1e-12,
                               rtol=0)


def test_dynamic_obstacle_with_periodic_axis_on_blocks():
    """``test_dynamic_obstacle_with_periodic_axis`` with its Field on (4, 1)
    blocks of the 33 x 33 grid (the seam layout along the periodic x): each
    solve keeps its solution on the blocks; the whole Field's placed, the
    view-based and the JAX decomposed runs' ``itr`` and values."""
    shifts = (0, 7, 15)

    class OnBlocks:
        """``PLACED`` whose Fields go on the blocks as they are made."""

        def __getattr__(self, name):
            return getattr(PLACED, name)

        @staticmethod
        def Field(*a, **k):
            f = Field(*a, **k)
            f.VAR = blocks.put(f(), PLACED.DD((4, 1)))
            return f

    g0 = blocks.gathers
    got, _ = dynamic(OnBlocks(), (4, 1), shifts)
    assert blocks.gathers == g0
    for ref in (dynamic(PLACED, (4, 1), shifts)[0], dynamic(PORT, (4, 1), shifts)[0],
                dynamic(JAX, (4, 1), shifts)[0]):
        for (a, ra), (b, rb) in zip(got, ref):
            assert ra["itr"] == rb["itr"] and ra["converge"]
            np.testing.assert_allclose(a, b, atol=1e-10, rtol=0)
