"""The variable-Γ diffusion apply and Jacobi pass of the port against the
JAX package (CPU, float64).

* The plain ``apply_diff_field`` against the JAX ``apply_diff_field`` on
  unaligned 2-D and 3-D grids, isotropic and stacked Γ, both face rules,
  with and without Neumann surgery, on EVERY row: the same flux-form
  arithmetic in the same order, held to 1e-12 relative.
* ``apply_diff_field`` and ``apply_diff_jacobi`` against the TPU kernels
  ``pallas_diff_field`` and ``pallas_diff_jacobi`` in interpret mode at
  ``(8, 16, 128)`` (the shape ``tests/test_pallas.py`` runs them at): the
  kernels stage the x-halo rows, so the comparison is on the active
  (interior) rows; 1e-12 relative (the kernels sum the coefficient form in
  another order).
* ``apply_diff_jacobi`` against the JAX V-cycle composition ``x + ω (b -
  A x) mask / diag`` with the JAX ``MGSpec._vg_diag`` diagonal, every row.
* The plane march's launch geometry (its ``(tj, 128)`` tiles per dtype)
  covers every point once over the single sweep's sweep of shapes and
  chunks, and the kernel a shape takes (march or per-point) follows from
  the shape alone (the kernels themselves run on the card:
  ``tests/test_torch_cuda.py``).

Γ reaches the port through ``gamma_from_numpy``. On the CPU the wrappers
``diff_field`` / ``diff_jacobi`` are the plain versions and count no
launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.ops import stencil as jst  # noqa: E402
from pyapes_tpu.ops.pallas_advect import pallas_diff_field, pallas_diff_jacobi  # noqa: E402
from pyapes_tpu.solver.multigrid import MGSpec as JMGSpec  # noqa: E402
from pyapes_tpu_torch.ops import diff_field as dmod  # noqa: E402
from pyapes_tpu_torch.ops import stencil as pst  # noqa: E402
from pyapes_tpu_torch.ops.diff_field import diff_field, diff_jacobi  # noqa: E402
from pyapes_tpu_torch.solver.multigrid import _level_shapes  # noqa: E402
from pyapes_tpu_torch.utils.carry import gamma_from_numpy  # noqa: E402
from test_torch_jacobi import (  # noqa: E402
    GEOMETRY_CASES,
    GEOMETRY_SHAPES,
    _covers_each_point_once,
)

NONE3 = (("none", "none"),) * 3
MIXED3 = (("neumann", "none"), ("none", "neumann"), ("neumann", "neumann"))
SURGERY = {"none": NONE3, "neumann": MIXED3}
INV = (4.0, 9.0, 25.0)
KSHAPE = (8, 16, 128)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _inputs(shape, seed, aniso=False, vdim=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((vdim,) + shape)
    b = rng.standard_normal((vdim,) + shape)
    g = 1.0 + rng.random(((len(shape),) if aniso else ()) + shape)
    return x, b, g


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("avg", ["arithmetic", "harmonic"])
@pytest.mark.parametrize("surgery", sorted(SURGERY))
def test_diff_field_vs_jax_pallas_interpret(surgery, avg):
    x, _, g = _inputs(KSHAPE, 5)
    surg = SURGERY[surgery]
    ref = np.asarray(pallas_diff_field(jnp.asarray(x[0]), jnp.asarray(g), INV, surg, avg=avg,
                                       interpret=True))
    xt = _t(x)
    gt = gamma_from_numpy(g, xt)
    out = pst.apply_diff_field(xt, gt, INV, surg, avg)[0].numpy()
    inner = (slice(1, -1),) * 3
    assert _rel(out[inner], ref[inner]) <= 1e-12
    before = diff_field.launches
    assert torch.equal(diff_field(xt, gt, INV, surg, avg), pst.apply_diff_field(xt, gt, INV, surg,
                                                                               avg))
    assert diff_field.launches == before


@pytest.mark.parametrize("mode", ["smooth", "smooth0", "resid"])
def test_diff_jacobi_vs_jax_pallas_interpret(mode):
    x, b, g = _inputs(KSHAPE, 12)
    xt, bt = _t(x), _t(b)
    gt = gamma_from_numpy(g, bt)
    inner = (slice(1, -1),) * 3
    for (surgery, avg) in (("none", "harmonic"), ("neumann", "arithmetic")):
        surg = SURGERY[surgery]
        ref = np.asarray(pallas_diff_jacobi(
            None if mode == "smooth0" else jnp.asarray(x[0]), jnp.asarray(b[0]), jnp.asarray(g),
            INV, surg, avg=avg, omega=0.7, mask_axes=(0, 1, 2), mode=mode, interpret=True))
        xm = None if mode == "smooth0" else xt
        out = pst.apply_diff_jacobi(xm, bt, gt, INV, surg, avg, 0.7, (0, 1, 2), mode)[0].numpy()
        assert _rel(out[inner], ref[inner]) <= 1e-12, (surgery, avg)
        before = diff_jacobi.launches
        got = diff_jacobi(xm, bt, gt, INV, surg, avg, 0.7, (0, 1, 2), mode)
        assert torch.equal(got[0], torch.from_numpy(out)) and diff_jacobi.launches == before


@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("shape", [(9, 12, 11), (13, 10), (3, 4, 5)])
def test_apply_diff_field_vs_jax_every_row(shape, aniso):
    nd = len(shape)
    x, _, g = _inputs(shape, 7, aniso=aniso, vdim=2)
    for surg in (NONE3[:nd], MIXED3[:nd]):
        for avg in ("arithmetic", "harmonic"):
            inv = INV[:nd]
            ref = jst.apply_diff_field(jnp.asarray(x), jnp.asarray(g), inv, surg, avg=avg)
            out = pst.apply_diff_field(_t(x), _t(g), inv, surg, avg)
            assert _rel(out.numpy(), ref) <= 1e-12, (surg, avg)


@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("shape", [(9, 12, 11), (13, 10)])
def test_diff_jacobi_vs_jax_mg_composition(shape, aniso):
    """``apply_diff_jacobi`` == the JAX V-cycle's jnp composition, with the
    JAX ``_vg_diag`` diagonal (and ``diff_diag`` == ``_vg_diag``)."""
    nd = len(shape)
    fk = (("neumann", "dirichlet"), ("dirichlet", "neumann"), ("dirichlet", "dirichlet"))[:nd]
    x, b, g = _inputs(shape, 9, aniso=aniso)
    for avg in ("arithmetic", "harmonic"):
        spec = JMGSpec(shape, [1.0, 2.0, 0.5][:nd], dtype=jnp.float64, face_kinds=fk,
                       var_gamma=True, vg_avg=avg, omega=0.8)
        inv, surg = tuple(spec._inv_dx2(shape)), spec._vg_surgery()
        jdiag = np.asarray(spec._vg_diag(jnp.asarray(g), shape))
        assert _rel(pst.diff_diag(_t(g), inv, surg, avg).numpy(), jdiag) <= 1e-12
        mask = np.asarray(spec._mask(shape))
        ax = np.asarray(jst.apply_diff_field(jnp.asarray(x), jnp.asarray(g), inv, surg, avg=avg))
        refs = {"smooth": x + 0.8 * (b - ax) * mask / jdiag, "smooth0": 0.8 * b * mask / jdiag,
                "resid": (b - ax) * mask}
        for mode, ref in refs.items():
            out = pst.apply_diff_jacobi(None if mode == "smooth0" else _t(x), _t(b), _t(g), inv,
                                        surg, avg, 0.8, tuple(range(nd)), mode)
            assert _rel(out.numpy(), ref) <= 1e-12, (avg, mode)


def test_gamma_from_numpy_carries_dtype_device_layout():
    like = torch.zeros((1, 5, 6), dtype=torch.float32)
    iso = np.random.default_rng(0).random((5, 6))
    stacked = np.stack([iso, 2 * iso])[:, :, ::-1]  # a non-contiguous numpy view
    for g in (iso, stacked):
        t = gamma_from_numpy(g, like)
        assert t.dtype == torch.float32 and t.device == like.device and t.is_contiguous()
        assert np.array_equal(t.numpy(), g.astype(np.float32))


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
@pytest.mark.parametrize("chunk, resident", GEOMETRY_CASES)
def test_vg_march_geometry_covers_each_point_once(shape, chunk, resident):
    """The variable-Γ march's launch geometry: 16 x 128 tiles (bf16, f32)
    and 8 x 128 (f64), chunks of planes, each point once."""
    for tile in sorted(set(dmod._VG_TILE.values())):
        _covers_each_point_once(shape, chunk, resident, tile, dmod._VG_SETUP_PLANES)


@pytest.mark.parametrize("shape, march", [
    ((1, 1025, 1025), False), ((1, 4097, 4097), False), ((2, 65, 130), False),  # 2-D
    ((1, 32, 32, 32), False), ((1, 4, 4, 4), False), ((1, 64, 64, 64), False),  # below
    ((3, 40, 50, 60), False), ((1, 127, 128, 128), False), ((4, 65, 33, 129), False),
    ((1, 128, 128, 128), True), ((1, 256, 256, 256), True), ((1, 512, 512, 512), True),
    ((1, 129, 129, 129), True), ((2, 70, 190, 200), True), ((1, 4096, 8, 64), True)])
def test_kernel_choice_follows_the_shape_alone(shape, march):
    """2-D grids and grids below ``MARCH_MIN_POINTS`` points per component
    take the per-point kernel, the rest the plane march; nothing else
    (dtype, Γ layout, a failure) enters the choice."""
    assert dmod.uses_march(shape) is march
    assert dmod.uses_march(shape) == (len(shape) == 4
                                      and np.prod(shape[1:]) >= dmod.MARCH_MIN_POINTS)


@pytest.mark.parametrize("n", [256, 512])
def test_darcy_levels_take_the_kernel_of_their_size(n):
    """On the Darcy cycle's levels the march takes 128^3 and up, the
    per-point kernel 64^3 and below; the march's levels, every tile inside
    the grid, take its ``FULL`` instance in every dtype."""
    for shape in _level_shapes((n,) * 3):
        assert dmod.uses_march((1, *shape)) is (shape[0] >= 128), shape
        if shape[0] >= 128:
            assert all(dmod.march_full((1, *shape), dt) for dt in dmod._VG_TILE), shape
    assert not dmod.march_full((1, 64, 64, 64), torch.bfloat16)  # 64 columns < one tile


@pytest.mark.parametrize("dtype, shape, full", [
    (torch.bfloat16, (1, 8, 16, 128), True), (torch.float32, (2, 3, 32, 256), True),
    (torch.float64, (1, 5, 8, 128), True), (torch.float32, (1, 5, 8, 128), False),
    (torch.bfloat16, (1, 9, 16, 129), False), (torch.float64, (1, 9, 12, 128), False),
    # the card tests' FULL grids, in every dtype
    *[(dt, shape, True) for shape in ((1, 20, 32, 256), (2, 9, 16, 128))
      for dt in (torch.bfloat16, torch.float32, torch.float64)]])
def test_march_full_needs_every_tile_inside(dtype, shape, full):
    assert dmod.march_full(shape, dtype) is full


@pytest.mark.parametrize("shape, grid", [((1, 5, 9, 17), (1, 9, 5)), ((3, 64, 64, 64), (1, 64, 192)),
                                         ((1, 1025, 1025), (9, 1025, 1)), ((2, 7, 10), (1, 7, 2)),
                                         ((1, 3, 300, 257), (3, 300, 3))])
def test_point_grid(shape, grid):
    """The per-point kernel's grid: 128 threads along the last axis, one
    block row per middle index, one z per (component, plane)."""
    assert dmod.point_grid(shape) == grid


@pytest.mark.parametrize("march", [None, True, False])
def test_cpu_tensor_takes_the_plain_version_whatever_the_kernel(march):
    """``march`` and ``chunk`` choose among the kernels of a CUDA tensor;
    a CPU tensor always takes the plain version and counts no launch."""
    x, b, g = _inputs((9, 12, 11), 3)
    xt, bt, gt = _t(x), _t(b), _t(g)
    surg = MIXED3
    before = (diff_field.launches, diff_jacobi.launches)
    assert torch.equal(diff_field(xt, gt, INV, surg, "harmonic", march=march, chunk=2),
                       pst.apply_diff_field(xt, gt, INV, surg, "harmonic"))
    for mode in ("smooth", "smooth0", "resid"):
        xm = None if mode == "smooth0" else xt
        got = diff_jacobi(xm, bt, gt, INV, surg, "arithmetic", 0.8, (0, 1, 2), mode,
                          march=march, chunk=3)
        assert torch.equal(got, pst.apply_diff_jacobi(xm, bt, gt, INV, surg, "arithmetic", 0.8,
                                                      (0, 1, 2), mode))
    assert (diff_field.launches, diff_jacobi.launches) == before
