"""The Hopper kernels on the card, against their plain PyTorch versions.
Needs an NVIDIA GPU and nvcc; skips without a GPU. This file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: kernel and plain version compute in promote(dtype, f32) and
sum the same products in another order (the kernel may fuse
multiply-adds), so f32 |kernel - plain| <= 1e-5 * max|plain|, f64 1e-12;
bf16 rounds the output once, and an f32 difference at a rounding boundary
moves it by one bf16 ulp (2^-8 relative): 1e-2 * max|plain|. Dots are held
to the same factors times sum|products| (f32 and bf16 dots are f32 sums).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu_torch.ops.axis_stencil import axis_stencil, axis_stencil_dot  # noqa: E402
from pyapes_tpu_torch.ops.jacobi import jacobi3d, jacobi3d_dot, jacobi3d_x2  # noqa: E402
from pyapes_tpu_torch.ops.stencil import (  # noqa: E402
    apply_axis_stencil,
    apply_axis_stencil_dot,
    apply_jacobi3d,
    apply_jacobi3d_dot,
    apply_jacobi3d_x2,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 1e-2}
DOT_TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 1e-5}
DTYPES = [torch.float32, torch.bfloat16, torch.float64]
# chip_smoke.py's kernel shapes (vdim, nx, ny, nz) minus the 512^3 one
SHAPES = [(3, 64, 64, 64), (1, 65, 33, 129), (1, 4, 4, 4), (1, 5, 9, 17)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(shape, vdim, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    coeffs = tuple(
        tuple(torch.randn(n, generator=g, dtype=torch.float64).to(device, dtype) for _ in range(3))
        for n in shape
    )
    x = torch.randn((vdim, *shape), generator=g, dtype=torch.float64).to(device, dtype)
    return coeffs, x


def _close(out, ref, dtype):
    err = (out.double() - ref.double()).abs().max().item()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert err <= TOL[dtype] * ref.double().abs().max().item(), err


def _dot_close(dot, ref, terms, dtype):
    assert dot.shape == ref.shape == (ref.shape[0], 1, 1, 1)
    scale = terms.double().abs().sum(dim=(1, 2, 3)).reshape(-1, 1, 1, 1)
    err = (dot.double() - ref.double()).abs()
    assert (err <= DOT_TOL[dtype] * scale).all(), (err.flatten(), scale.flatten())


@pytest.mark.parametrize(
    "shape, vdim, dtype",
    [((33, 34, 35), 1, torch.float64), ((16, 32, 128), 3, torch.float32),
     ((65, 33, 129), 1, torch.float32), ((3, 3, 3), 2, torch.float64),
     ((1025, 130), 1, torch.float32), ((7, 5), 3, torch.float64),
     ((300,), 2, torch.float32), ((3,), 1, torch.float64),
     ((65, 33, 129), 1, torch.bfloat16), ((9, 130), 2, torch.bfloat16)],
)
def test_kernel_matches_plain(cuda, shape, vdim, dtype):
    coeffs, x = _inputs(shape, vdim, dtype, cuda)
    before = axis_stencil.launches
    out = axis_stencil(coeffs, x)
    torch.cuda.synchronize()
    assert axis_stencil.launches == before + 1
    _close(out, apply_axis_stencil(coeffs, x), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_axis_stencil_dot_matches_plain(cuda, shape, dtype):
    coeffs, x = _inputs(shape[1:], shape[0], dtype, cuda, seed=1)
    before = axis_stencil_dot.launches
    out, dot = axis_stencil_dot(coeffs, x)
    torch.cuda.synchronize()
    assert axis_stencil_dot.launches == before + 1
    ref, ref_dot = apply_axis_stencil_dot(coeffs, x)
    _close(out, ref, dtype)
    _dot_close(dot, ref_dot, x.double() * ref.double(), dtype)


def _level(shape, dtype, device, seed):
    """A V-cycle level's operands: unit-box inv_dx2, omega/diag, x, b."""
    inv = [float((n - 1) ** 2) for n in shape[1:]]
    beta = 0.857 / (-2.0 * sum(inv))
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float64).to(device, dtype)
    b = (sum(inv) * torch.randn(shape, generator=g, dtype=torch.float64)).to(device, dtype)
    return inv, beta, x, b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", ["smooth", "residual", "dot", "x2", "x2_zero", "x2_dot",
                                     "x2_zero_dot"])
def test_jacobi_kernels_match_plain(cuda, shape, dtype, variant):
    inv, beta, x, b = _level(shape, dtype, cuda, seed=2)
    axes = (0, 1, 2) if variant != "x2_dot" else (0, 2)
    if variant in ("smooth", "residual"):
        alpha, bt = (1.0, beta) if variant == "smooth" else (0.0, 1.0)
        before = jacobi3d.launches
        out = jacobi3d(x, b, inv, alpha, bt, axes)
        assert jacobi3d.launches == before + 1
        _close(out, apply_jacobi3d(x, b, inv, alpha, bt, axes), dtype)
    elif variant == "dot":
        before = jacobi3d_dot.launches
        out, dot = jacobi3d_dot(x, b, inv, 1.0, beta, axes)
        assert jacobi3d_dot.launches == before + 1
        ref, ref_dot = apply_jacobi3d_dot(x, b, inv, 1.0, beta, axes)
        _close(out, ref, dtype)
        _dot_close(dot, ref_dot, b.double() * ref.double(), dtype)
    else:
        zero, emit = "zero" in variant, variant.endswith("dot")
        before = jacobi3d_x2.launches
        got = jacobi3d_x2(None if zero else x, b, inv, beta, axes, from_zero=zero, emit_dot=emit)
        assert jacobi3d_x2.launches == before + 1
        ref = apply_jacobi3d_x2(x, b, inv, beta, axes, from_zero=zero, emit_dot=emit)
        if emit:
            _close(got[0], ref[0], dtype)
            _dot_close(got[1], ref[1], b.double() * ref[0].double(), dtype)
        else:
            _close(got, ref, dtype)
    torch.cuda.synchronize()


def test_x2_equals_two_single_sweeps_f64(cuda):
    inv, beta, x, b = _level((2, 17, 9, 33), torch.float64, cuda, seed=3)
    axes = (0, 1, 2)
    two = jacobi3d(jacobi3d(x, b, inv, 1.0, beta, axes), b, inv, 1.0, beta, axes)
    _close(jacobi3d_x2(x, b, inv, beta, axes), two, torch.float64)


def test_kernel_rejects_noncontiguous(cuda):
    coeffs, x = _inputs((8, 9, 10), 1, torch.float32, cuda)
    with pytest.raises(ValueError):
        axis_stencil(coeffs, x.transpose(1, 3))
    with pytest.raises(ValueError):
        jacobi3d(x.transpose(1, 3), x.transpose(1, 3), [1.0] * 3, 1.0, 0.1, (0, 1, 2))


def test_cuda_solve_matches_cpu(cuda):
    """The fastdiag slice end to end on the card (f64) equals the CPU run."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import PoissonSolver
    from pyapes_tpu_torch.testing.poisson import poisson_bcs, poisson_rhs_nd

    sols = []
    for dev in ("cpu", "cuda"):
        mesh = Mesh(Box[0:1, 0:1, 0:1], None, [17, 19, 21], device=dev, dtype="double")
        ps = PoissonSolver(mesh, poisson_bcs(3))
        before = axis_stencil.launches
        ps.solve(poisson_rhs_nd(mesh, ps.var))
        assert ps.report["converge"]
        assert (axis_stencil.launches > before) == (dev == "cuda")
        sols.append(ps.var()[0].cpu().numpy())
    assert np.abs(sols[0] - sols[1]).max() <= 1e-12 * np.abs(sols[0]).max()


@pytest.mark.parametrize("mg_opts", [
    {"n_pre": 2, "n_post": 2, "omega": 0.857, "fmg": True, "fuse_rz": True},
    {"n_pre": 1, "n_post": 1, "fuse_rz": True, "transfers": "matrix"},
])
def test_cuda_mgpcg_matches_cpu(cuda, mg_opts):
    """MG-PCG end to end on the card (f64 cycle) equals the CPU run: same
    iterations, and every kernel of the path launched on the card."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    rhs = np.random.default_rng(4).standard_normal((1, 33, 17, 40))
    out = []
    for dev in ("cpu", "cuda"):
        mesh = Mesh(Box[0:1, 0:1, 0:1], None, [33, 17, 40], device=dev, dtype="double")
        var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet")}, init_val=0.0)
        s = Solver({"fdm": {"method": "cg", "precond": "mg", "tol": 1e-10, "max_it": 100,
                            "criterion": "residual", "mg_opts": mg_opts}})
        s.set_eq(FDM().laplacian(1.0, var) == torch.from_numpy(rhs).to(dev))
        counts = [f.launches for f in (axis_stencil_dot, jacobi3d, jacobi3d_x2, jacobi3d_dot)]
        rep = s.solve()
        grew = [f.launches > c for f, c in
                zip((axis_stencil_dot, jacobi3d, jacobi3d_x2, jacobi3d_dot), counts)]
        assert rep["converge"]
        if dev == "cuda":
            assert grew[:2] == [True, True]
            assert grew[2] or grew[3]
        out.append((rep["itr"], var()[0].cpu().numpy()))
    assert out[0][0] == out[1][0]
    assert np.abs(out[0][1] - out[1][1]).max() <= 1e-10 * np.abs(out[0][1]).max()
