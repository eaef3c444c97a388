"""Parity of the port's axis stencil with the JAX package (CPU, float64).

The port's ``axis_stencil`` wrapper runs its plain PyTorch version on a
CPU tensor; it is held against the JAX roll-sum AND the JAX Pallas
kernels in interpret mode, at the shapes of ``tests/test_pallas.py``. The
kernel-specific input checks of the wrapper are exercised on CPU tensors
too (``check_inputs`` is device-agnostic).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.ops.pallas_stencil import pallas_axis_stencil  # noqa: E402
from pyapes_tpu.ops.pallas_stencil_db import pallas_axis_stencil_db  # noqa: E402
from pyapes_tpu.ops.stencil import apply_axis_stencil as jax_apply  # noqa: E402
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil, check_inputs  # noqa: E402
from pyapes_tpu_torch.ops.stencil import apply_axis_stencil  # noqa: E402
from pyapes_tpu_torch.utils.carry import coeffs_from_numpy  # noqa: E402

RTOL = 1e-12  # float64: both sides sum the same products, order may differ


def _inputs(shape, vdim, seed=5):
    rng = np.random.default_rng(seed)
    coeffs = tuple(tuple(rng.standard_normal(n) for _ in range(3)) for n in shape)
    x = rng.standard_normal((vdim,) + shape)
    return coeffs, x


def _jax(coeffs):
    return tuple(tuple(jnp.asarray(c) for c in cs) for cs in coeffs)


def _close(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= RTOL * np.abs(np.asarray(want)).max(), err


@pytest.mark.parametrize("vdim", [1, 3])
@pytest.mark.parametrize(
    "shape, pallas",
    [((8, 16, 128), True), ((16, 32, 128), True), ((16, 128), True),
     ((7, 9, 11), False), ((13,), False)],
)
def test_axis_stencil_matches_jax(shape, pallas, vdim):
    coeffs, x = _inputs(shape, vdim)
    port = axis_stencil(coeffs_from_numpy(coeffs, "cpu", torch.float64), torch.from_numpy(x))
    assert port.dtype == torch.float64 and tuple(port.shape) == x.shape
    _close(port.numpy(), jax_apply(_jax(coeffs), jnp.asarray(x)))
    if pallas:
        _close(port.numpy(), pallas_axis_stencil(_jax(coeffs), jnp.asarray(x), interpret=True))
        if len(shape) == 3:
            _close(port.numpy(), pallas_axis_stencil_db(_jax(coeffs), jnp.asarray(x), interpret=True))


def test_wrapper_uses_plain_version_on_cpu():
    coeffs, x = _inputs((5, 6, 7), 2)
    c = coeffs_from_numpy(coeffs, "cpu", torch.float64)
    xt = torch.from_numpy(x)
    before = axis_stencil.launches
    assert torch.equal(axis_stencil(c, xt), apply_axis_stencil(c, xt))
    assert axis_stencil.launches == before


def _bad_inputs(case):
    coeffs, x = _inputs((5, 6, 7), 1)
    c = list(coeffs_from_numpy(coeffs, "cpu", torch.float64))
    xt = torch.from_numpy(x)
    if case == "dtype":
        return coeffs_from_numpy(coeffs, "cpu", torch.float16), xt.half()
    if case == "noncontig":
        return c, xt.transpose(1, 3)
    if case == "axes":
        return c[:2], xt
    if case == "five_point":
        c[0] = c[0] + c[0][:2]
        return c, xt
    if case == "length":
        c[1] = (c[1][0][:-1], c[1][1], c[1][2])
        return c, xt
    if case == "coeff_dtype":
        c[2] = tuple(v.float() for v in c[2])
        return c, xt
    if case == "too_small":
        c2 = coeffs_from_numpy(_inputs((2, 6, 7), 1)[0], "cpu", torch.float64)
        return c2, torch.zeros((1, 2, 6, 7), dtype=torch.float64)
    if case == "launch_limit":
        c2 = coeffs_from_numpy(_inputs((70000, 3), 1)[0], "cpu", torch.float64)
        return c2, torch.zeros((1, 70000, 3), dtype=torch.float64)
    raise AssertionError(case)


@pytest.mark.parametrize(
    "case, exc",
    [("dtype", TypeError), ("noncontig", ValueError), ("axes", ValueError),
     ("five_point", NotImplementedError), ("length", ValueError),
     ("coeff_dtype", ValueError), ("too_small", ValueError),
     ("launch_limit", ValueError)],
)
def test_check_inputs_rejects(case, exc):
    coeffs, x = _bad_inputs(case)
    # a 5-point axis is rejected where the kernel takes 3-point axes only
    # (the CG alpha-dot); the apply takes it (axis_stencil5)
    points = (3,) if case == "five_point" else (3, 5)
    with pytest.raises(exc):
        check_inputs(coeffs, x, points)


def test_check_inputs_accepts_main_path_shapes():
    for shape, vdim in (((5, 6, 7), 3), ((9, 4), 1), ((11,), 2)):
        coeffs, x = _inputs(shape, vdim)
        check_inputs(coeffs_from_numpy(coeffs, "cpu", torch.float32), torch.from_numpy(x).float())
