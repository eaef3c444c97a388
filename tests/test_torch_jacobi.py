"""Parity of the plain versions of the slice-2 kernels with the JAX package
(CPU): the stencil alpha-dot, the fused Jacobi/residual step, the
Jacobi + dot step and the double Jacobi sweep.

Each plain PyTorch version (what the wrappers run on a CPU tensor, and the
oracle of the Hopper kernel on the card) is held against the JAX Pallas
functions in interpret mode at the shapes of ``tests/test_pallas.py``
(nz a multiple of 128), and against the JAX jnp path at odd shapes. Both
sides compute the same sums in another order: f64 1e-12 and f32 1e-5 of
the output's scale (dots: of the sum of |products|).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.ops.pallas_stencil import pallas_jacobi3d  # noqa: E402
from pyapes_tpu.ops.pallas_stencil_db import (  # noqa: E402
    pallas_axis_stencil_dot,
    pallas_jacobi3d_db,
    pallas_jacobi3d_dot_db,
)
from pyapes_tpu.ops.pallas_stencil_v3 import (  # noqa: E402
    pallas_axis_stencil_dot_v3,
    pallas_jacobi3d_v3,
    pallas_jacobi3d_x2,
)
from pyapes_tpu.ops.stencil import apply_axis_stencil as jax_apply  # noqa: E402
from pyapes_tpu.solver.multigrid import MGSpec as JMGSpec  # noqa: E402
from pyapes_tpu_torch.ops import jacobi  # noqa: E402
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil_dot  # noqa: E402
from pyapes_tpu_torch.ops.stencil import (  # noqa: E402
    apply_axis_stencil_dot,
    apply_jacobi3d,
    apply_jacobi3d_dot,
    apply_jacobi3d_x2,
)
from pyapes_tpu_torch.utils.carry import coeffs_from_numpy  # noqa: E402

TOL = {"float64": 1e-12, "float32": 1e-5}
TDT = {"float64": torch.float64, "float32": torch.float32}
PALLAS_SHAPES = [(1, 16, 16, 128), (2, 8, 16, 128)]


def _close(got, want, dt, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(got - want).max()
    assert err <= TOL[dt] * scale, (err, scale)


def _level(shape, dt, seed):
    """A V-cycle level's operands (unit box): inv_dx2, omega/diag, x, b."""
    rng = np.random.default_rng(seed)
    inv = tuple(float((n - 1) ** 2) for n in shape[1:])
    beta = 0.857 / (-2.0 * sum(inv))
    x = rng.standard_normal(shape).astype(dt)
    b = (sum(inv) * rng.standard_normal(shape)).astype(dt)
    return inv, beta, x, b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES)
@pytest.mark.parametrize("fn", [pallas_axis_stencil_dot, pallas_axis_stencil_dot_v3])
def test_axis_stencil_dot_vs_pallas(fn, shape, dt):
    rng = np.random.default_rng(7)
    coeffs = tuple(tuple(rng.standard_normal(n).astype(dt) for _ in range(3)) for n in shape[1:])
    x = rng.standard_normal(shape).astype(dt)
    out, dot = axis_stencil_dot(coeffs_from_numpy(coeffs, "cpu", TDT[dt]), _t(x))
    jout, jdot = fn(tuple(tuple(jnp.asarray(c) for c in cs) for cs in coeffs), jnp.asarray(x),
                    interpret=True)
    _close(out.numpy(), jout, dt)
    assert tuple(dot.shape) == (shape[0], 1, 1, 1)
    _close(dot.numpy(), jdot, dt, scale=np.abs(x * np.asarray(jout)).sum())


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES)
@pytest.mark.parametrize("fn", [pallas_jacobi3d, pallas_jacobi3d_db, pallas_jacobi3d_v3])
def test_jacobi3d_vs_pallas(fn, shape, dt):
    inv, beta, x, b = _level(shape, dt, seed=8)
    for alpha, bt, axes in ((1.0, beta, (0, 1, 2)), (0.0, 1.0, (0, 2))):
        got = jacobi.jacobi3d(_t(x), _t(b), inv, alpha, bt, axes)
        _close(got.numpy(), fn(jnp.asarray(x), jnp.asarray(b), inv, alpha, bt, axes,
                               interpret=True), dt)


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES)
def test_jacobi3d_dot_vs_pallas(shape, dt):
    inv, beta, x, b = _level(shape, dt, seed=9)
    out, dot = jacobi.jacobi3d_dot(_t(x), _t(b), inv, 1.0, beta, (0, 1, 2))
    jout, jdot = pallas_jacobi3d_dot_db(jnp.asarray(x), jnp.asarray(b), inv, 1.0, beta,
                                        (0, 1, 2), interpret=True)
    _close(out.numpy(), jout, dt)
    _close(dot.numpy().reshape(-1), jdot, dt, scale=np.abs(b * np.asarray(jout)).sum())


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES)
@pytest.mark.parametrize("from_zero, emit_dot, axes",
                         [(False, False, (0, 1, 2)), (True, False, (0, 1, 2)),
                          (False, True, (1, 2)), (True, True, (0, 1, 2))])
def test_jacobi3d_x2_vs_pallas(shape, dt, from_zero, emit_dot, axes):
    inv, beta, x, b = _level(shape, dt, seed=10)
    got = jacobi.jacobi3d_x2(None if from_zero else _t(x), _t(b), inv, beta, axes,
                             from_zero=from_zero, emit_dot=emit_dot)
    want = pallas_jacobi3d_x2(None if from_zero else jnp.asarray(x), jnp.asarray(b), inv,
                              beta, axes, from_zero=from_zero, emit_dot=emit_dot,
                              interpret=True)
    if emit_dot:
        _close(got[0].numpy(), want[0], dt)
        _close(got[1].numpy(), want[1], dt, scale=np.abs(b * np.asarray(want[0])).sum())
    else:
        _close(got.numpy(), want, dt)


@pytest.mark.parametrize("shape", [(1, 9, 12, 11), (2, 7, 10, 13), (1, 4, 4, 4)])
def test_vs_jax_jnp_path_odd_shapes(shape):
    """The JAX multigrid's jnp smooth/residual and the jnp roll-sum stencil
    at shapes no Pallas kernel takes (f64)."""
    spec = JMGSpec(shape[1:], (1.0, 1.0, 1.0), dtype=jnp.float64)
    inv = tuple(spec._inv_dx2(shape[1:]))
    om = spec.omega / spec._diag(shape[1:])
    _, _, x, b = _level(shape, "float64", seed=11)
    mask = spec._mask(shape[1:])
    jx, jb = jnp.asarray(x), jnp.asarray(b)
    axes = (0, 1, 2)
    _close(apply_jacobi3d(_t(x), _t(b), inv, 1.0, om, axes).numpy(),
           spec._smooth(jx, jb, shape[1:], mask, 1), "float64")
    _close(apply_jacobi3d(_t(x), _t(b), inv, 0.0, 1.0, axes).numpy(),
           spec._residual(jx, jb, shape[1:], mask), "float64")
    _close(apply_jacobi3d_x2(_t(x), _t(b), inv, om, axes).numpy(),
           spec._smooth(jx, jb, shape[1:], mask, 2), "float64")
    _close(apply_jacobi3d_x2(None, _t(b), inv, om, axes, from_zero=True).numpy(),
           spec._first_smooth(jb, shape[1:], mask, 2), "float64")
    jz = spec._smooth(jx, jb, shape[1:], mask, 1)
    z, dot = apply_jacobi3d_dot(_t(x), _t(b), inv, 1.0, om, axes)
    _close(z.numpy(), jz, "float64")
    _close(dot.numpy().reshape(-1), np.sum(b * np.asarray(jz), axis=(1, 2, 3)), "float64",
           scale=np.abs(b * np.asarray(jz)).sum())
    rng = np.random.default_rng(12)
    coeffs = tuple(tuple(rng.standard_normal(n) for _ in range(3)) for n in shape[1:])
    out, sdot = apply_axis_stencil_dot(coeffs_from_numpy(coeffs, "cpu", torch.float64), _t(x))
    jout = np.asarray(jax_apply(tuple(tuple(jnp.asarray(c) for c in cs) for cs in coeffs), jx))
    _close(out.numpy(), jout, "float64")
    _close(sdot.numpy().reshape(-1), np.sum(x * jout, axis=(1, 2, 3)), "float64",
           scale=np.abs(x * jout).sum())


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_x2_equals_two_single_sweeps(dt):
    """In f64/f32 the double sweep is two single sweeps (y is not rounded
    in between; in these dtypes that changes nothing beyond round-off)."""
    inv, beta, x, b = _level((2, 9, 6, 7), dt, seed=13)
    axes = (0, 1, 2)
    y = apply_jacobi3d(_t(x), _t(b), inv, 1.0, beta, axes)
    _close(apply_jacobi3d_x2(_t(x), _t(b), inv, beta, axes).numpy(),
           apply_jacobi3d(y, _t(b), inv, 1.0, beta, axes).numpy(), dt)
    zero = torch.zeros_like(_t(x))
    y0 = apply_jacobi3d(zero, _t(b), inv, 1.0, beta, axes)
    _close(apply_jacobi3d_x2(None, _t(b), inv, beta, axes, from_zero=True).numpy(),
           apply_jacobi3d(y0, _t(b), inv, 1.0, beta, axes).numpy(), dt)


def test_bf16_computes_in_f32_and_rounds_once():
    """bf16 storage: the plain versions widen to f32, and only the output
    is rounded — y between the two sweeps stays f32."""
    inv, beta, x, b = _level((1, 8, 9, 10), "float32", seed=14)
    xb, bb = _t(x).bfloat16(), _t(b).bfloat16()
    z = apply_jacobi3d_x2(xb, bb, inv, beta, (0, 1, 2))
    z32 = apply_jacobi3d_x2(xb.float(), bb.float(), inv, beta, (0, 1, 2))
    assert z.dtype == torch.bfloat16 and torch.equal(z, z32.bfloat16())
    z2, dot = apply_jacobi3d_x2(xb, bb, inv, beta, (0, 1, 2), emit_dot=True)
    assert dot.dtype == torch.float32 and torch.equal(z2, z)
    assert torch.allclose(dot, (bb.float() * z32).sum(dim=(1, 2, 3), keepdim=True), rtol=1e-6)


def _mg_level_shapes(n):
    """The V-cycle's level shapes of an n^3 grid (``MGSpec``'s rule)."""
    from pyapes_tpu_torch.solver.multigrid import _level_shapes

    return [(1, *s) for s in _level_shapes((n,) * 3)]


GEOMETRY_SHAPES = _mg_level_shapes(512) + _mg_level_shapes(256) + [
    (1, 4, 4, 4), (1, 5, 9, 17), (1, 65, 33, 129), (3, 64, 64, 64), (1, 130, 16, 64),
    (2, 70, 19, 131), (1, 3, 3, 3)]
GEOMETRY_CASES = [(None, 396), (None, 660), (None, 1), (64, 396), (5, 396), (1, 396)]


def _covers_each_point_once(shape, chunk, resident, tile, setup):
    """A plane march's launch geometry: the blocks' column tiles and plane
    chunks, as the kernel reads them off its block index, cover every
    output point of every component exactly once, and there is one dot
    partial per block."""
    (gx, gy, gz), ci, n_partial = jacobi.march_geometry(shape, resident, chunk, tile, setup)
    vdim, n0, n1, n2 = shape
    tj, tk = tile
    nch = -(-n0 // ci)
    assert gz == vdim * nch and n_partial * vdim == gx * gy * gz
    assert 1 <= ci <= n0 and (chunk is None or ci == min(chunk, n0))
    assert max(gy, gz) <= jacobi._MAX_GRID_YZ

    def cover(n_blocks, size, n):  # points of one axis each block index covers
        count = np.zeros(n, np.int64)
        for blk in range(n_blocks):
            lo = blk * size
            assert lo < n, "a block with no output"
            count[lo:min(lo + size, n)] += 1
        return count

    per_comp = np.zeros((vdim, n0), np.int64)
    for bz in range(gz):
        d, c = divmod(bz, nch)
        i0 = c * ci
        per_comp[d, i0:min(i0 + ci, n0)] += 1
    assert (per_comp == 1).all()
    assert (cover(gy, tj, n1) == 1).all() and (cover(gx, tk, n2) == 1).all()


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
@pytest.mark.parametrize("chunk, resident", GEOMETRY_CASES)
def test_x2_geometry_covers_each_point_once(shape, chunk, resident):
    """The double sweep's launch geometry (14 x 64 tiles)."""
    _covers_each_point_once(shape, chunk, resident, jacobi._X2_TILE, jacobi._X2_SETUP_PLANES)


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
@pytest.mark.parametrize("chunk, resident", GEOMETRY_CASES)
def test_jacobi3d_geometry_covers_each_point_once(shape, chunk, resident):
    """The single sweep's launch geometry (16 x 128 tiles)."""
    _covers_each_point_once(shape, chunk, resident, jacobi._J1_TILE, jacobi._J1_SETUP_PLANES)


@pytest.mark.parametrize("n, resident, chunk", [(512, 396, 128), (256, 396, 52), (128, 396, 7),
                                                (64, 396, 1), (512, 1, 512)])
def test_x2_chunk_fills_the_card(n, resident, chunk):
    """The chunk choice on the 512^3 cycle's levels for a card that holds
    396 blocks at once (3 per SM of 132): the fewest plane-steps, (waves
    of blocks) x (planes + the block's fixed cost); one long chunk where a
    single block at a time runs."""
    _, ci, _ = jacobi.march_geometry((1, n, n, n), resident, None, jacobi._X2_TILE,
                                     jacobi._X2_SETUP_PLANES)
    assert ci == chunk


@pytest.mark.parametrize("n, resident, chunk", [(512, 528, 128), (256, 528, 16), (128, 528, 2),
                                                (64, 528, 1), (4, 528, 1), (512, 396, 171),
                                                (256, 396, 22), (512, 1, 512)])
def test_jacobi3d_chunk_fills_the_card(n, resident, chunk):
    """The single sweep's chunk on the 512^3 cycle's levels (16 x 128
    tiles: 128 at 512^3, 32 at 256^3) for a card that holds 528 (4 per SM)
    or 396 blocks at once: the fewest plane-steps, (waves of blocks) x
    (planes + 2), so at least nine tenths of the blocks the card holds are
    in flight wherever the grid has that many (one per column tile and
    plane), and short chunks come only where the column tiles alone do not
    fill it."""
    (gx, gy, gz), ci, _ = jacobi.march_geometry((1, n, n, n), resident, None, jacobi._J1_TILE,
                                                 jacobi._J1_SETUP_PLANES)
    assert ci == chunk
    assert gx * gy * gz >= 0.9 * min(resident, gx * gy * n)
