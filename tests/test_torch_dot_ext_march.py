"""The alpha-dot and halo-extended axis-stencil kernels, as far as the CPU
reaches them.

``axis_stencil_dot`` and ``axis_stencil_ext`` each have two kernels: an
instance of the radius-1 plane march (``csrc/axis_march.cu``,
``axis_march_dot_kernel`` and ``axis_march_ext_kernel``) and the per-point
kernel (``csrc/axis_stencil.cu``). Both run on the card only
(``tests/test_torch_cuda.py``); here:

* the march's launch geometry (16 x 128 tiles, chunks of planes of one
  component) covers every output point of every component exactly once,
  with one dot partial per block: for the dot over the single sweep's
  sweep of shapes and chunks, for the halo-extended apply at the (4, 2, 1)
  blocks of every 512^3 and 256^3 MG level and at ``chip_smoke.py``'s odd
  blocks; there every plane and row the march stages lies inside the
  extended block and is the neighbour the plain version reads;
* the kernel a call takes follows from the shape (the dot) or the block's
  shape and the output view (the halo-extended apply) alone, whatever the
  ext flags;
* on a CPU tensor both wrappers give the JAX package's
  ``pallas_axis_stencil_dot`` (``_v3``) and ``pallas_axis_stencil_ext``
  results in interpret mode to 1e-12 in f64, whatever ``march`` and
  ``chunk`` say, and count no launch; ``march=True`` on a grid other than
  3-D raises.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.ops.pallas_stencil_db import pallas_axis_stencil_dot  # noqa: E402
from pyapes_tpu.ops.pallas_stencil_v3 import (  # noqa: E402
    pallas_axis_stencil_dot_v3,
    pallas_axis_stencil_ext,
)
from pyapes_tpu_torch.ops import axis_stencil as amod  # noqa: E402
from pyapes_tpu_torch.ops import march  # noqa: E402
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil_dot, axis_stencil_ext  # noqa: E402
from pyapes_tpu_torch.parallel import DomainDecomposition, halo  # noqa: E402
from pyapes_tpu_torch.solver.multigrid import _level_shapes  # noqa: E402
from test_torch_jacobi import (  # noqa: E402
    GEOMETRY_CASES,
    GEOMETRY_SHAPES,
    _covers_each_point_once,
)

TILE, SETUP = amod._TILE, amod._SETUP_PLANES[1]
N_DECOMP = (4, 2, 1)  # chip_smoke.py's decomposed paths
EXT = tuple(int(m > 1) for m in N_DECOMP)
# chip_smoke.py's EXT_BLOCKS: unextended blocks (vdim, n0, n1, n2), odd
# sizes and single-row axes among them
ODD_BLOCKS = [(1, 5, 7, 33), (3, 16, 9, 130), (1, 3, 5, 257), (3, 1, 2, 64)]
EXT_FLAGS = [(1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 0)]


def _level_blocks(n):
    """The unextended (4, 2, 1) blocks of every level of the n^3 MG
    hierarchy that the decomposed cycle applies block-wise."""
    dd = DomainDecomposition(N_DECOMP)
    out = []
    for shape in _level_shapes((n,) * 3):
        if halo.sharded_supported(dd, shape):
            out += [(1, *(s.stop - s.start for s in sl)) for _, sl in dd.blocks(shape)][:1]
    return out


LEVEL_BLOCKS = list(dict.fromkeys(_level_blocks(512) + _level_blocks(256)))


def test_level_blocks_are_the_paths():
    """The block-wise levels of the 512^3 hierarchy, from its (4, 2, 1)
    fine-level block down; the 256^3 hierarchy's are among them."""
    assert LEVEL_BLOCKS[:3] == [(1, 128, 256, 512), (1, 64, 128, 256), (1, 32, 64, 128)]
    assert set(_level_blocks(256)) <= set(_level_blocks(512)) == set(LEVEL_BLOCKS)


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
@pytest.mark.parametrize("chunk, resident", GEOMETRY_CASES)
def test_dot_march_geometry_covers_each_point_once(shape, chunk, resident):
    """The alpha-dot march's blocks cover every point of every component
    once, one partial each, no chunk crossing a component."""
    _covers_each_point_once(shape, chunk, resident, TILE, SETUP)


def _ext_plane(p, n0, e0):
    """The plane of the extended block the march stages for output plane
    ``p`` (``p`` = -1 .. n0): the ghost plane on an extended axis 0, else
    the wrap (csrc/axis_march.cu, ``stage``)."""
    return p + e0 if e0 else p % n0


def _ext_row(j, n1, e1):
    """The row of the extended block the march's window stages for output
    row ``j`` (``j`` = -1 .. n1): the ghost row on an extended axis 1, else
    the wrap (``rowoff``)."""
    return j + e1 if e1 else j % n1


@pytest.mark.parametrize("ext", EXT_FLAGS)
@pytest.mark.parametrize("shape", LEVEL_BLOCKS + ODD_BLOCKS)
@pytest.mark.parametrize("chunk, resident", GEOMETRY_CASES)
def test_ext_march_geometry_covers_each_point_once(shape, ext, chunk, resident):
    """The halo-extended march's blocks cover every point of the
    unextended block once; the planes and window rows each block stages
    lie inside the extended block, and the ones a point reads are its
    neighbours there (the next row on an extended axis, the wrap on the
    others)."""
    _covers_each_point_once(shape, chunk, resident, TILE, SETUP)
    (gx, gy, gz), ci, _ = march.march_geometry(shape, resident, chunk, TILE, SETUP)
    _, n0, n1, n2 = shape
    e0, e1 = ext[:2]
    nch = -(-n0 // ci)
    for bz in range(nch):  # the chunks of one component
        i0 = bz * ci
        i1 = min(i0 + ci, n0)
        planes = [_ext_plane(p, n0, e0) for p in range(i0 - 1, i1 + 1)]
        assert min(planes) >= 0 and max(planes) < n0 + 2 * e0
        for i in range(i0, i1):  # a point's planes i-1, i, i+1 in extended coordinates
            want = [i + e0 - 1, i + e0, i + e0 + 1] if e0 else [(i - 1) % n0, i, (i + 1) % n0]
            assert planes[i - i0:i - i0 + 3] == want
    for by in range(gy):
        j0 = by * TILE[0]
        tr = min(TILE[0], n1 - j0)
        rows = [_ext_row(j, n1, e1) for j in range(j0 - 1, j0 + tr + 1)]  # tr + 2 staged
        assert min(rows) >= 0 and max(rows) < n1 + 2 * e1
        for j in range(j0, j0 + tr):
            want = [j + e1 - 1, j + e1, j + e1 + 1] if e1 else [(j - 1) % n1, j, (j + 1) % n1]
            assert rows[j - j0:j - j0 + 3] == want


@pytest.mark.parametrize("shape, march_", [
    ((1, 512, 512, 512), True), ((1, 256, 256, 256), True), ((1, 128, 128, 128), True),
    ((3, 64, 64, 128), False), ((1, 64, 64, 64), False), ((1, 129, 129, 129), False),
    ((1, 4, 4, 4), False), ((2, 70, 192, 256), True), ((1, 512, 520, 512), False),
    ((1, 255, 256, 256), True), ((3, 127, 128, 128), False), ((1, 65, 130), False)])
def test_dot_kernel_choice_follows_the_shape_alone(shape, march_):
    """The alpha-dot takes the march where the apply does: 3-D grids of at
    least ``MARCH_MIN_POINTS`` points per component whose every tile lies
    inside them (MG-PCG 512^3's and the 256^3 V(1,1) operator among
    them)."""
    assert amod.uses_march(shape) is march_


def _view(block, kind):
    """An output view of ``block`` (vdim, n0, n1, n2): ``global`` the
    block's view of its (4, 2, 1) global result, ``odd_offset`` a view
    one element into its last axis, ``odd_stride`` a view of a tensor with
    odd rows, None a new tensor."""
    vdim, n0, n1, n2 = block
    if kind is None:
        return None
    if kind == "global":
        g = torch.zeros((vdim, n0 * N_DECOMP[0], n1 * N_DECOMP[1], n2))
        return g[:, n0:2 * n0, n1:2 * n1]
    if kind == "odd_offset":
        return torch.zeros((vdim, n0, n1, n2 + 1))[..., 1:]
    return torch.zeros((vdim, n0, n1, n2 + 1 + n2 % 2))[..., :n2]


@pytest.mark.parametrize("ext", EXT_FLAGS)
@pytest.mark.parametrize("kind", [None, "global", "odd_offset", "odd_stride"])
@pytest.mark.parametrize("block, march_", [
    ((1, 128, 256, 512), True), ((1, 64, 128, 256), True), ((1, 32, 64, 128), False),
    ((1, 16, 32, 64), False), ((1, 5, 7, 33), False), ((3, 16, 9, 130), False),
    ((1, 127, 128, 128), False), ((2, 128, 32, 512), True), ((1, 64, 136, 256), False)])
def test_ext_kernel_choice_follows_the_block_and_view_alone(block, march_, kind, ext):
    """The halo-extended apply takes the march where its unextended block
    takes the apply's march and the output view takes pair stores (an even
    base and even strides); the ext flags do not enter the choice. In the
    (4, 2, 1) blocks the 512^3 and 256^3 levels take it, 128^3 and below
    the per-point kernel."""
    out = _view(block, kind)
    pairs = kind is None or (kind == "global" and block[3] % 2 == 0)
    assert out is None or amod.pair_stores(out) is pairs
    assert amod.uses_march_ext(block, out) is (march_ and pairs)


@pytest.mark.parametrize("n, march_", [(512, True), (256, True), (128, False), (64, False)])
def test_decomposed_levels_take_the_march_from_256(n, march_):
    """In (4, 2, 1) blocks the 512^3 and 256^3 MG levels take the march,
    128^3 and below the per-point kernel."""
    dd = DomainDecomposition(N_DECOMP)
    glob = torch.zeros((1, n, n, n))
    for _, sl in dd.blocks((n, n, n)):
        block = (1, *(s.stop - s.start for s in sl))
        assert amod.uses_march_ext(block, glob[(slice(None), *sl)]) is march_


def _cs(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(tuple(rng.standard_normal(n) for _ in range(3)) for n in shape)


def _t(cs):
    return tuple(tuple(torch.from_numpy(c) for c in triple) for triple in cs)


def _j(cs):
    return tuple(tuple(jnp.asarray(c) for c in triple) for triple in cs)


DOT_SHAPES = [(1, 16, 16, 128), (2, 8, 16, 128)]  # tests/test_pallas.py's (nz % 128 == 0)
DOT_FNS = {"db": pallas_axis_stencil_dot, "v3": pallas_axis_stencil_dot_v3}


@functools.lru_cache(maxsize=None)
def _jax_dot(fn, case):
    shape = DOT_SHAPES[case]
    cs = _cs(shape[1:], 50 + case)
    x = np.random.default_rng(60 + case).standard_normal(shape)
    out, dot = DOT_FNS[fn](_j(cs), jnp.asarray(x), interpret=True)
    return cs, x, np.asarray(out), np.asarray(dot)


@pytest.mark.parametrize("march_, chunk", [(None, None), (True, 3), (False, None), (True, None)])
@pytest.mark.parametrize("case", range(len(DOT_SHAPES)))
@pytest.mark.parametrize("fn", list(DOT_FNS))
def test_dot_cpu_matches_pallas_whatever_the_kernel(fn, case, march_, chunk):
    """On a CPU tensor ``axis_stencil_dot`` is the plain version whatever
    ``march`` and ``chunk`` say: the JAX kernel's ``A x`` and dot in
    interpret mode to 1e-12 (f64), no launch counted."""
    cs, x, jout, jdot = _jax_dot(fn, case)
    before = axis_stencil_dot.launches
    out, dot = axis_stencil_dot(_t(cs), torch.from_numpy(x), march=march_, chunk=chunk)
    assert axis_stencil_dot.launches == before
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-12 * np.abs(jout).max())
    assert tuple(dot.shape) == (x.shape[0], 1, 1, 1)
    scale = np.abs(x * jout).sum()
    np.testing.assert_allclose(dot.numpy().reshape(jdot.shape), jdot, rtol=0, atol=1e-12 * scale)


EXT_CASES = [((1, 8 + 2, 16, 128), (1, 0, 0)), ((2, 8 + 2, 8 + 2, 128), (1, 1, 0)),
             ((1, 8, 16 + 2, 128), (0, 1, 0)), ((3, 4 + 2, 16, 256), (1, 0, 0))]


@functools.lru_cache(maxsize=None)
def _jax_ext(case):
    shape, ext = EXT_CASES[case]
    nx = [s - 2 * e for s, e in zip(shape[1:], ext)]
    cs = _cs(nx, 70 + case)
    x = np.random.default_rng(80 + case).standard_normal(shape)
    return cs, x, np.asarray(pallas_axis_stencil_ext(_j(cs), jnp.asarray(x), ext, interpret=True))


@pytest.mark.parametrize("into", ["new", "view"])
@pytest.mark.parametrize("march_, chunk", [(None, None), (True, 2), (False, None)])
@pytest.mark.parametrize("case", range(len(EXT_CASES)))
def test_ext_cpu_matches_pallas_whatever_the_kernel(case, march_, chunk, into):
    """On a CPU tensor ``axis_stencil_ext`` is the plain version whatever
    ``march`` and ``chunk`` say, into a new tensor or a view: the JAX
    kernel in interpret mode to 1e-12 (f64), no launch counted."""
    cs, x, ref = _jax_ext(case)
    ext = EXT_CASES[case][1]
    out = None
    if into == "view":
        big = torch.zeros((ref.shape[0], ref.shape[1] + 1, ref.shape[2] + 2, ref.shape[3]),
                          dtype=torch.float64)
        out = big[:, 1:, 2:]
    before = axis_stencil_ext.launches
    got = axis_stencil_ext(_t(cs), torch.from_numpy(x), ext, out=out, march=march_, chunk=chunk)
    assert axis_stencil_ext.launches == before
    assert out is None or got is out
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(1, 65, 130), (2, 300)])
def test_forced_march_on_a_grid_other_than_3d_raises(shape):
    """``march=True`` on a 1-D or 2-D grid raises, on the CPU too: neither
    wrapper falls back."""
    x = torch.zeros(shape, dtype=torch.float64)
    cs = tuple(tuple(torch.zeros(n, dtype=torch.float64) for _ in range(3)) for n in shape[1:])
    with pytest.raises(ValueError):
        axis_stencil_dot(cs, x, march=True)
    with pytest.raises(ValueError):
        axis_stencil_ext(cs, x, (1,) + (0,) * (len(shape) - 2), march=True)
