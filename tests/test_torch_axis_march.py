"""The per-axis stencil apply's two kernels, as far as the CPU reaches them.

The plane march (``csrc/axis_march.cu``, radius 1 for ``axis_stencil``, 2
for ``axis_stencil5``) and the per-point kernels run on the card only
(``tests/test_torch_cuda.py``); here:

* the march's launch geometry (16 x 128 tiles, chunks of planes of one
  component) covers every output point of every component exactly once,
  for both radii, over the single sweep's sweep of shapes and chunks, the
  advection paths' shapes (vdim 3, a 3-node axis 0) and ragged chunks;
* the kernel a shape takes follows from the shape alone: 1-D and 2-D
  grids, grids below ``MARCH_MIN_POINTS`` and grids that a column tile
  overhangs take the per-point kernel; the paths' large 3-D grids, every
  tile inside them, the march's ``FULL`` instance;
* on a CPU tensor the wrappers are the plain version whatever ``march`` and
  ``chunk`` say, and count no launch.

The wrappers' parity with the JAX package (``pallas_axis_stencil``,
``_db``, ``_v5`` in interpret mode) is in ``tests/test_torch_stencil.py``
and ``tests/test_torch_advect.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu_torch.ops import axis_stencil as amod  # noqa: E402
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil, axis_stencil5  # noqa: E402
from pyapes_tpu_torch.ops.stencil import apply_axis_stencil  # noqa: E402
from pyapes_tpu_torch.solver.multigrid import _level_shapes  # noqa: E402
from test_torch_jacobi import (  # noqa: E402
    GEOMETRY_CASES,
    GEOMETRY_SHAPES,
    _covers_each_point_once,
)

# the advection paths' grids and the check shapes of chip_smoke.py: vdim
# 3, a 3-node axis 0, odd sizes
PATH_SHAPES = [(3, 256, 256, 256), (1, 256, 256, 256), (3, 3, 9, 11), (1, 33, 34, 35),
               (3, 65, 33, 129), (2, 20, 32, 256)]
RAGGED_CASES = [(7, 396), (3, 264), (2, 1), (100, 396)]


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("shape", GEOMETRY_SHAPES + PATH_SHAPES)
@pytest.mark.parametrize("chunk, resident", GEOMETRY_CASES + RAGGED_CASES)
def test_march_geometry_covers_each_point_once(shape, chunk, resident, radius):
    """Each block's tile and plane chunk, read off its block index as the
    kernel reads them, cover every point of every component once; no
    chunk crosses a component."""
    _covers_each_point_once(shape, chunk, resident, amod._TILE, amod._SETUP_PLANES[radius])


@pytest.mark.parametrize("shape, march", [
    ((1, 512), False), ((3, 300), False), ((1, 1025, 1025), False), ((2, 65, 130), False),
    ((1, 4097, 4097), False),  # 1-D and 2-D
    ((1, 4, 4, 4), False), ((3, 3, 9, 11), False), ((1, 32, 32, 32), False),
    ((1, 64, 64, 64), False), ((1, 65, 65, 65), False), ((3, 40, 50, 60), False),
    ((1, 127, 128, 128), False),  # below the threshold
    ((1, 129, 129, 129), False), ((1, 4096, 8, 64), False),  # a tile overhangs the grid
    ((2, 70, 190, 200), False), ((1, 200, 256, 100), False), ((1, 257, 257, 257), False),
    ((1, 512, 512, 500), False), ((1, 512, 520, 512), False), ((3, 255, 256, 256), True),
    ((1, 128, 128, 128), True), ((1, 256, 256, 256), True), ((3, 256, 256, 256), True),
    ((1, 512, 512, 512), True), ((2, 70, 192, 256), True), ((1, 200, 256, 128), True),
    ((1, 8192, 16, 128), True), ((1, 64, 64, 128), False), ((1, 64, 128, 256), True)])
def test_kernel_choice_follows_the_shape_alone(shape, march):
    """3-D grids of at least ``MARCH_MIN_POINTS`` points per component
    whose every column tile lies inside them take the march, the rest the
    per-point kernel; nothing else (dtype, radius, vdim, a failure) enters
    the choice."""
    assert amod.uses_march(shape) is march
    assert amod.uses_march(shape) == (len(shape) == 4
                                      and np.prod(shape[1:]) >= amod.MARCH_MIN_POINTS
                                      and amod.march_full(shape))


@pytest.mark.parametrize("n", [256, 512])
def test_path_grids_take_the_full_march(n):
    """The paths' large grids (fastdiag and MG-PCG 512^3, the advection
    paths' 256^3 torus) take the march's ``FULL`` instance; the V-cycle's
    levels from 128^3 up the march, below it the per-point kernel."""
    assert amod.uses_march((1, n, n, n)) and amod.march_full((1, n, n, n))
    for shape in _level_shapes((n,) * 3):
        assert amod.uses_march((1, *shape)) is (shape[0] >= 128), shape


@pytest.mark.parametrize("shape, full", [
    ((1, 8, 16, 128), True), ((3, 3, 32, 256), True), ((1, 512, 512, 512), True),
    ((1, 9, 16, 129), False), ((1, 9, 12, 128), False), ((1, 65, 33, 129), False),
    ((1, 64, 64, 64), False), ((2, 20, 32, 256), True)])
def test_march_full_needs_every_tile_inside(shape, full):
    assert amod.march_full(shape) is full


def _inputs(shape, points, seed):
    rng = np.random.default_rng(seed)
    coeffs = tuple(tuple(torch.from_numpy(rng.standard_normal(n)) for _ in range(p))
                   for n, p in zip(shape[1:], points))
    return coeffs, torch.from_numpy(rng.standard_normal(shape))


@pytest.mark.parametrize("march", [None, True, False])
@pytest.mark.parametrize("points", [(3, 3, 3), (5, 3, 5)])
def test_cpu_tensor_takes_the_plain_version_whatever_the_kernel(march, points):
    """``march`` and ``chunk`` choose among the kernels of a CUDA tensor;
    a CPU tensor always takes the plain version (a 5-point equation too)
    and counts no launch."""
    coeffs, x = _inputs((2, 9, 12, 11), points, 3)
    before = (axis_stencil.launches, axis_stencil5.launches)
    want = apply_axis_stencil(coeffs, x)
    assert torch.equal(axis_stencil(coeffs, x, march=march, chunk=2), want)
    assert torch.equal(axis_stencil5(coeffs, x, march=march, chunk=3), want)
    assert (axis_stencil.launches, axis_stencil5.launches) == before
