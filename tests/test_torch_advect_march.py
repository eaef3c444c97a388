"""The advection kernels' plane march, as far as the CPU reaches it.

The plane march (``csrc/advect_march.cu``) and the per-point kernel
(``csrc/advect.cu``) of ``advect_pair`` and ``conv_component`` run on the
card only (``tests/test_torch_cuda.py``); here:

* the march's launch geometry (16 x 128 tiles, 8 x 128 in f64; chunks of
  planes of one output component) covers every output point once, over
  the single sweep's sweep of shapes and chunks and the paths' shapes
  (the Burgers and upwind grids, the (4, 2, 1) block of 512^3);
* the kernel a call takes follows from the shape and the limiter alone:
  1-D and 2-D grids, grids below ``MARCH_MIN_POINTS``, grids that a
  column tile overhangs and QUICK take the per-point kernel;
* on a CPU tensor the wrappers are the plain version, equal to the JAX
  package's TPU kernels ``pallas_advect_pair`` / ``pallas_conv_component``
  in interpret mode within 1e-12, whatever ``march`` and ``chunk`` say, and
  count no launch;
* ``march=True`` on a 2-D grid or with QUICK raises.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.ops.pallas_advect import pallas_advect_pair, pallas_conv_component  # noqa: E402
from pyapes_tpu_torch.ops import advect  # noqa: E402
from pyapes_tpu_torch.ops.advect import advect_pair, conv_component  # noqa: E402
from pyapes_tpu_torch.utils.carry import gamma_from_numpy  # noqa: E402
from test_torch_advect import KSHAPE, SURGERY, _bases, _inputs, _rel, _t  # noqa: E402
from test_torch_jacobi import (  # noqa: E402
    GEOMETRY_CASES,
    GEOMETRY_SHAPES,
    _covers_each_point_once,
)

# the paths' grids as the march launches them ((output components, n0,
# n1, n2): Burgers' Conv of one component at 256^3, the upwind Div, a
# three-component Conv), the (4, 2, 1) block of 512^3 and the check shapes
# of chip_smoke.py (a 3-node axis 0, the FULL grids)
PATH_SHAPES = [(1, 256, 256, 256), (3, 256, 256, 256), (1, 128, 256, 512), (3, 3, 9, 11),
               (1, 20, 32, 256), (3, 9, 16, 128)]
TILES = sorted(set(advect._TILE.values()))
DIV_VARIANTS = [("none", "conservative"), ("none", "advective"), ("upwind", "conservative")]
MARCH_CHUNK = [(None, None), (True, None), (True, 3), (True, 64), (False, None)]


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("shape", GEOMETRY_SHAPES + PATH_SHAPES)
@pytest.mark.parametrize("chunk, resident", GEOMETRY_CASES)
def test_march_geometry_covers_each_point_once(shape, chunk, resident, tile):
    """Each block's tile and plane chunk, read off its block index as the
    kernel reads them, cover every point of every output component once;
    no chunk crosses a component."""
    _covers_each_point_once(shape, chunk, resident, tile, advect._SETUP_PLANES)


@pytest.mark.parametrize("limiter", ["none", "upwind", "quick"])
@pytest.mark.parametrize("shape, march", [
    ((1, 512), False), ((3, 300), False), ((1, 1025, 1025), False), ((1, 4096, 4096), False),
    ((1, 64, 64, 64), False), ((3, 3, 9, 11), False), ((1, 127, 128, 128), False),
    ((1, 129, 129, 129), False), ((1, 257, 257, 257), False), ((1, 512, 520, 512), False),
    ((1, 64, 64, 128), False), ((1, 128, 128, 128), True), ((1, 256, 256, 256), True),
    ((3, 256, 256, 256), True), ((1, 128, 256, 512), True), ((1, 512, 512, 512), True),
    ((2, 70, 192, 256), True), ((1, 8192, 16, 128), True)])
def test_kernel_choice_follows_shape_and_limiter_alone(shape, march, limiter):
    """3-D grids of at least ``MARCH_MIN_POINTS`` points per component
    whose every 16 x 128 tile lies inside them take the march with the
    central and upwind limiters; QUICK, 1-D, 2-D, small and overhung grids
    the per-point kernel."""
    want = march and limiter != "quick"
    assert advect.uses_march(shape, limiter) is want
    assert want == (len(shape) == 4 and np.prod(shape[1:]) >= advect.MARCH_MIN_POINTS
                    and advect.march_full(shape) and limiter != "quick")


@pytest.mark.parametrize("shape, dtype, full", [
    ((1, 16, 16, 128), torch.float32, True), ((1, 8, 8, 128), torch.float64, True),
    ((1, 8, 8, 128), torch.float32, False), ((1, 8, 8, 128), torch.bfloat16, False),
    ((1, 9, 16, 129), torch.float64, False), ((1, 256, 256, 256), torch.bfloat16, True)])
def test_march_full_follows_the_dtype_tile(shape, dtype, full):
    """The ``FULL`` instance of a dtype: every tile of that dtype (16 x 128;
    8 x 128 in f64) inside the grid."""
    assert advect.march_full(shape, dtype) is full


@functools.lru_cache(maxsize=None)
def _pallas_div(limiter, form, kind, vdim):
    """``pallas_advect_pair`` in interpret mode as the JAX operator calls
    it (one launch over the axes for a scalar target, one per pair for a
    vector one), with the numpy inputs."""
    jb, _ = _bases(KSHAPE)
    x, a = _inputs(KSHAPE, vdim, vdim, 70 + vdim)
    surg = SURGERY[kind]
    if vdim == 1:
        ref = pallas_advect_pair(jnp.asarray(x[0]), jnp.asarray(a[0]), jb, (0, 1, 2), limiter,
                                 surg, form, interpret=True)
    else:
        ref = sum(pallas_advect_pair(jnp.asarray(x[j]), jnp.asarray(a[j]), jb, (j,), limiter,
                                     surg, form, interpret=True) for j in range(3))
    return x, a, np.asarray(ref)


@pytest.mark.parametrize("vdim", [1, 3])
@pytest.mark.parametrize("kind", sorted(SURGERY))
@pytest.mark.parametrize("variant", DIV_VARIANTS, ids=lambda v: f"{v[0]}-{v[1][:4]}")
def test_cpu_div_is_the_tpu_kernel_whatever_the_kernel(variant, kind, vdim):
    """``advect_pair`` on a CPU tensor: the plain version, equal to
    ``pallas_advect_pair`` within 1e-12 at every ``march``/``chunk``; no
    launch counted."""
    limiter, form = variant
    x, a, ref = _pallas_div(limiter, form, kind, vdim)
    _, pb = _bases(KSHAPE)
    xt = _t(x)
    at = gamma_from_numpy(a, xt)
    before = advect_pair.launches
    outs = [advect_pair(xt, at, pb, limiter, SURGERY[kind], form, march=m, chunk=c)
            for m, c in MARCH_CHUNK]
    assert _rel(outs[0][0].numpy(), ref) <= 1e-12
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert advect_pair.launches == before


@pytest.mark.parametrize("kind", sorted(SURGERY))
@pytest.mark.parametrize("limiter", ["none", "upwind"])
def test_cpu_conv_is_the_tpu_kernel_whatever_the_kernel(limiter, kind):
    """``conv_component`` on a CPU tensor: the plain version, equal to
    ``pallas_conv_component`` (once per target component, stacked) within
    1e-12 at every ``march``/``chunk``; no launch counted."""
    surg = SURGERY[kind]
    jb, pb = _bases(KSHAPE)
    x, a = _inputs(KSHAPE, 2, 3, 80)
    ja = jnp.asarray(a)
    ref = np.stack([np.asarray(pallas_conv_component(jnp.asarray(x[i]), ja, jb, limiter, surg,
                                                     interpret=True)) for i in range(2)])
    before = conv_component.launches
    outs = [conv_component(_t(x), _t(a), pb, limiter, surg, march=m, chunk=c)
            for m, c in MARCH_CHUNK]
    assert _rel(outs[0].numpy(), ref) <= 1e-12
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert conv_component.launches == before


def _args(shape, vdim=1):
    x = torch.zeros((vdim, *shape), dtype=torch.float64)
    adv = torch.ones((len(shape) if vdim > 1 else 1, *shape), dtype=torch.float64)
    base = tuple(tuple(torch.full((n,), v, dtype=torch.float64) for v in (0.5, 0.0, -0.5))
                 for n in shape)
    return x, adv, base, (("none", "none"),) * len(shape)


@pytest.mark.parametrize("case", ["div_2d", "conv_2d", "div_quick", "conv_quick", "div_1d"])
def test_forced_march_raises_where_it_does_not_run(case):
    """``march=True`` on a 1-D or 2-D grid or with QUICK raises on any
    device (it never falls back); ``march=False`` or None there runs."""
    shape = {"div_2d": (9, 12), "conv_2d": (9, 12), "div_1d": (11,)}.get(case, (5, 6, 7))
    limiter = "quick" if case.endswith("quick") else "upwind"
    if case.startswith("conv"):
        x, adv, base, surg = _args(shape, vdim=2)
        adv = torch.ones((len(shape), *shape), dtype=torch.float64)
        call = functools.partial(conv_component, x, adv, base, limiter, surg)
    else:
        x, adv, base, surg = _args(shape)
        call = functools.partial(advect_pair, x, adv, base, limiter, surg)
    with pytest.raises(ValueError, match="plane march"):
        call(march=True)
    assert torch.equal(call(march=False), call())
