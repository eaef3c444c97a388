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
from pyapes_tpu_torch.ops import stencil as pst  # noqa: E402
from pyapes_tpu_torch.ops.diff_field import diff_field, diff_jacobi  # noqa: E402
from pyapes_tpu_torch.utils.carry import gamma_from_numpy  # noqa: E402

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
