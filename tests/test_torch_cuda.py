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

from pyapes_tpu_torch.ops import advect as advect_mod  # noqa: E402
from pyapes_tpu_torch.ops import axis_stencil as axis_mod  # noqa: E402
from pyapes_tpu_torch.ops import jacobi as jacobi_mod  # noqa: E402
from pyapes_tpu_torch.ops.advect import advect_pair, conv_component  # noqa: E402
from pyapes_tpu_torch.ops.axis_stencil import (  # noqa: E402
    axis_stencil,
    axis_stencil5,
    axis_stencil_dot,
    axis_stencil_ext,
)
from pyapes_tpu_torch.ops.diff_field import diff_field, diff_jacobi  # noqa: E402
from pyapes_tpu_torch.ops.jacobi import jacobi3d, jacobi3d_dot, jacobi3d_x2  # noqa: E402
from pyapes_tpu_torch.ops.stencil import (  # noqa: E402
    apply_axis_stencil,
    apply_axis_stencil_dot,
    apply_axis_stencil_ext,
    apply_conv_field,
    apply_diff_field,
    apply_diff_jacobi,
    apply_div_field,
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
# the plane marches' (single and double sweep) own edges: more planes than
# a chunk and not a multiple of it, odd n2 with n1 not a multiple of a
# tile's rows, 3-node axes
X2_SHAPES = [(1, 130, 16, 64), (2, 70, 19, 131), (1, 3, 3, 3)]
# planes per block: the launch geometry's choice, the most, a ragged few
CHUNKS = [None, 64, 3]
# the variable-Γ kernels: those plus 2-D grids; chip_smoke.py's (stacked Γ,
# face rule, Neumann surgery) combinations
VG_SHAPES = SHAPES + [(1, 65, 130), (2, 17, 9)]
VG_COMBOS = [(False, "arithmetic", False), (False, "harmonic", True),
             (True, "arithmetic", True), (True, "harmonic", False)]
# the advection kernels: chip_smoke.py's shapes, (3, 3, 9, 11) with a
# 3-node axis 0 that the "neumann" kind gives Neumann faces on both sides,
# a 2-D and a 1-D grid; its surgery kinds and Div variants
ADV_SHAPES = [(3, 64, 64, 64), (1, 65, 33, 129), (1, 4, 4, 4), (1, 5, 9, 17), (3, 3, 9, 11),
              (1, 65, 130), (2, 300)]
ADV_SURGERY = {
    "none": (("none", "none"),) * 3,
    "neumann": (("neumann", "neumann"),) * 3,
    "mixed": (("periodic", "neumann"), ("none", "periodic"), ("neumann", "none")),
}
DIV_VARIANTS = [("none", "conservative"), ("none", "advective"), ("upwind", "conservative"),
                ("quick", "conservative")]


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


JACOBI_VARIANTS = ["smooth", "residual", "dot"]
# the single sweep on a subset of the masked axes
JACOBI_SUB_VARIANTS = ["residual_axes02", "dot_axes12"]
X2_VARIANTS = ["x2", "x2_zero", "x2_dot", "x2_zero_dot"]
AXES = {"x2_dot": (0, 2), "residual_axes02": (0, 2), "dot_axes12": (1, 2)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape, variant",
                         [(s, v) for v in JACOBI_VARIANTS + X2_VARIANTS for s in SHAPES]
                         + [(s, v) for v in X2_VARIANTS for s in X2_SHAPES]
                         + [(s, v) for v in JACOBI_VARIANTS + JACOBI_SUB_VARIANTS for s in X2_SHAPES]
                         + [(s, v) for v in JACOBI_SUB_VARIANTS for s in SHAPES])
def test_jacobi_kernels_match_plain(cuda, shape, dtype, variant):
    """Every kernel of the Jacobi family against its plain version, with
    the launch geometry's plane chunk and with explicit ones (the seams)."""
    inv, beta, x, b = _level(shape, dtype, cuda, seed=2)
    axes = AXES.get(variant, (0, 1, 2))
    kind = variant.split("_axes")[0]
    if kind in ("smooth", "residual"):
        alpha, bt = (1.0, beta) if kind == "smooth" else (0.0, 1.0)
        ref = apply_jacobi3d(x, b, inv, alpha, bt, axes)
        for chunk in CHUNKS:
            before = jacobi3d.launches
            out = jacobi3d(x, b, inv, alpha, bt, axes, chunk=chunk)
            assert jacobi3d.launches == before + 1
            _close(out, ref, dtype)
    elif kind == "dot":
        ref, ref_dot = apply_jacobi3d_dot(x, b, inv, 1.0, beta, axes)
        for chunk in CHUNKS:
            before = jacobi3d_dot.launches
            out, dot = jacobi3d_dot(x, b, inv, 1.0, beta, axes, chunk=chunk)
            assert jacobi3d_dot.launches == before + 1
            _close(out, ref, dtype)
            _dot_close(dot, ref_dot, b.double() * ref.double(), dtype)
    else:
        zero, emit = "zero" in variant, variant.endswith("dot")
        ref = apply_jacobi3d_x2(x, b, inv, beta, axes, from_zero=zero, emit_dot=emit)
        for chunk in CHUNKS:
            before = jacobi3d_x2.launches
            got = jacobi3d_x2(None if zero else x, b, inv, beta, axes, from_zero=zero,
                              emit_dot=emit, chunk=chunk)
            assert jacobi3d_x2.launches == before + 1
            if emit:
                _close(got[0], ref[0], dtype)
                _dot_close(got[1], ref[1], b.double() * ref[0].double(), dtype)
            else:
                _close(got, ref, dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("combo", range(len(VG_COMBOS)))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", VG_SHAPES)
def test_diff_kernels_match_plain(cuda, shape, dtype, combo):
    """``diff_field`` and the three ``diff_jacobi`` modes against their
    plain versions on every row (the kernels wrap as ``torch.roll``)."""
    aniso, avg, neumann = VG_COMBOS[combo]
    inv, _, x, b = _level(shape, dtype, cuda, seed=5)
    nd = len(shape) - 1
    gen = torch.Generator(device="cpu").manual_seed(6)
    g = (1.0 + torch.rand(((nd,) if aniso else ()) + shape[1:], generator=gen,
                          dtype=torch.float64)).to(cuda, dtype)
    mixed = (("neumann", "none"), ("none", "neumann"), ("neumann", "neumann"))
    surg = mixed[:nd] if neumann else (("none", "none"),) * nd
    axes = tuple(range(nd))
    before = (diff_field.launches, diff_jacobi.launches)
    _close(diff_field(x, g, inv, surg, avg), apply_diff_field(x, g, inv, surg, avg), dtype)
    for mode in ("smooth", "smooth0", "resid"):
        xm = None if mode == "smooth0" else x
        _close(diff_jacobi(xm, b, g, inv, surg, avg, 0.857, axes, mode),
               apply_diff_jacobi(xm, b, g, inv, surg, avg, 0.857, axes, mode), dtype)
    torch.cuda.synchronize()
    assert (diff_field.launches, diff_jacobi.launches) == (before[0] + 1, before[1] + 3)


@pytest.mark.parametrize("shape, chunk", [((2, 17, 9, 33), None), ((1, 130, 16, 64), 64),
                                          ((2, 70, 19, 131), 16)])
def test_x2_equals_two_single_sweeps_f64(cuda, shape, chunk):
    """In f64 the double sweep is two single sweeps, across the seams of
    several plane chunks too."""
    inv, beta, x, b = _level(shape, torch.float64, cuda, seed=3)
    axes = (0, 1, 2)
    two = jacobi3d(jacobi3d(x, b, inv, 1.0, beta, axes), b, inv, 1.0, beta, axes)
    _close(jacobi3d_x2(x, b, inv, beta, axes, chunk=chunk), two, torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_x2_dot_same_bits_every_call(cuda, dtype):
    """The fused r.z is summed in a fixed order (one partial per block, no
    atomics): two calls give the same bits, output and dot."""
    inv, beta, x, b = _level((1, 130, 70, 131), dtype, cuda, seed=4)
    z1, d1 = jacobi3d_x2(x, b, inv, beta, (0, 1, 2), emit_dot=True)
    z2, d2 = jacobi3d_x2(x, b, inv, beta, (0, 1, 2), emit_dot=True)
    assert torch.equal(z1, z2) and torch.equal(d1, d2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi3d_dot_same_bits_every_call(cuda, dtype):
    """The single sweep's fused r.z is summed in a fixed order too (one
    partial per block, no atomics): two calls give the same bits."""
    inv, beta, x, b = _level((1, 130, 70, 131), dtype, cuda, seed=4)
    z1, d1 = jacobi3d_dot(x, b, inv, 1.0, beta, (0, 1, 2))
    z2, d2 = jacobi3d_dot(x, b, inv, 1.0, beta, (0, 1, 2))
    assert torch.equal(z1, z2) and torch.equal(d1, d2)


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


@pytest.mark.parametrize("case", ["cg_dirichlet_3d", "bicgstab_neumann_harmonic_2d"])
def test_cuda_var_gamma_solve_matches_cpu(cuda, case):
    """The variable-Γ slice end to end on the card (f64 cycle) equals the
    CPU run: same iterations, and both variable-Γ kernels launched."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs, mixed_bcs

    rng = np.random.default_rng(7)
    if case == "cg_dirichlet_3d":
        nx, bcs, method, avg = [33, 17, 40], homogeneous_bcs(3, 0.0, "dirichlet"), "cg", "arithmetic"
    else:
        nx, method, avg = [65, 47], "bicgstab", "harmonic"
        bcs = mixed_bcs([1.0, 0.0, 0.0, 0.0], ["dirichlet", "dirichlet", "neumann", "neumann"])
    gamma = np.exp(rng.standard_normal(nx))
    rhs = rng.standard_normal((1, *nx))
    out = []
    for dev in ("cpu", "cuda"):
        mesh = Mesh(Box[tuple(slice(0, 1) for _ in nx)], None, nx, device=dev, dtype="double")
        var = Field("p", 1, mesh, {"domain": bcs}, init_val=0.0)
        s = Solver({"fdm": {"method": method, "precond": "mg", "tol": 1e-10, "max_it": 200,
                            "criterion": "residual", "mg_opts": {"fmg": True}}})
        s.set_eq(FDM().laplacian(gamma, var, avg=avg) == torch.from_numpy(rhs).to(dev))
        before = (diff_field.launches, diff_jacobi.launches)
        rep = s.solve()
        assert rep["converge"]
        grew = (diff_field.launches > before[0], diff_jacobi.launches > before[1])
        assert grew == ((True, True) if dev == "cuda" else (False, False))
        out.append((rep["itr"], var()[0].cpu().numpy()))
    assert out[0][0] == out[1][0]
    assert np.abs(out[0][1] - out[1][1]).max() <= 1e-10 * np.abs(out[0][1]).max()


def _adv_inputs(shape, dtype, device, seed):
    """Target, Div advector (one per target component), Conv advector (one
    per axis), unit-box base vectors, and 5-point coefficients (axes 0 and
    2 of 5 vectors, axis 1 of 3)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    nd = len(shape) - 1

    def rnd(*sh):
        return torch.randn(sh, generator=g, dtype=torch.float64).to(device, dtype)

    base = tuple(tuple(torch.full((n,), v, dtype=torch.float64).to(device, dtype)
                       for v in (0.5 * (n - 1), 0.0, -0.5 * (n - 1))) for n in shape[1:])
    c5 = tuple(tuple(rnd(n) for _ in range(3 if j == 1 else 5)) for j, n in enumerate(shape[1:]))
    return rnd(*shape), rnd(*shape), rnd(nd, *shape[1:]), base, c5


@pytest.mark.parametrize("kind", sorted(ADV_SURGERY))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ADV_SHAPES)
def test_advect_kernels_match_plain(cuda, shape, dtype, kind):
    """``advect_pair`` (every limiter, both forms, vector and scalar
    targets) and ``conv_component`` (every limiter) against their plain
    versions on every row, one launch each."""
    x, adv, adv_conv, base, _ = _adv_inputs(shape, dtype, cuda, 8)
    surg = ADV_SURGERY[kind][: len(shape) - 1]
    for limiter, form in DIV_VARIANTS:
        for xs, av in ((x, adv), (x[:1], adv[:1])):
            before = advect_pair.launches
            out = advect_pair(xs, av, base, limiter, surg, form)
            assert advect_pair.launches == before + 1
            _close(out, apply_div_field(xs, av, base, limiter, surg, form), dtype)
    for limiter in ("none", "upwind", "quick"):
        before = conv_component.launches
        out = conv_component(x, adv_conv, base, limiter, surg)
        assert conv_component.launches == before + 1
        _close(out, apply_conv_field(x, adv_conv, base, limiter, surg), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ADV_SHAPES)
def test_axis_stencil5_matches_plain(cuda, shape, dtype):
    """Mixed 5- and 3-point axes, torus wrap at the +-2 reach; ``axis_stencil``
    hands the equation to the 5-point kernel."""
    x, _, _, _, c5 = _adv_inputs(shape, dtype, cuda, 9)
    before = (axis_stencil.launches, axis_stencil5.launches)
    ref = apply_axis_stencil(c5, x)
    _close(axis_stencil5(c5, x), ref, dtype)
    _close(axis_stencil(c5, x), ref, dtype)
    torch.cuda.synchronize()
    assert (axis_stencil.launches, axis_stencil5.launches) == (before[0], before[1] + 2)


@pytest.mark.parametrize("name", ["advect_pair", "conv_component", "axis_stencil5",
                                  "axis_stencil_ext", "jacobi3d", "jacobi3d_dot"])
def test_cuda_tensor_never_reaches_the_plain_version(cuda, name, monkeypatch):
    """With the plain versions patched to raise, the wrappers still answer
    a CUDA tensor: from the kernel."""
    def plain(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    x, adv, adv_conv, base, c5 = _adv_inputs((1, 9, 10, 11), torch.float32, cuda, 10)
    c3 = tuple(tuple(c[:n - 2] for c in cs[:3]) if j == 0 else cs[:3]
               for j, (cs, n) in enumerate(zip(c5, x.shape[1:])))
    surg = ADV_SURGERY["mixed"]
    inv, beta, _, b = _level(tuple(x.shape), torch.float32, cuda, seed=11)
    ref = {"jacobi3d": lambda: apply_jacobi3d(x, b, inv, 0.0, 1.0, (0, 1, 2)),
           "jacobi3d_dot": lambda: apply_jacobi3d_dot(x, b, inv, 1.0, beta, (0, 1, 2))[0],
           "advect_pair": lambda: apply_div_field(x, adv, base, "upwind", surg),
           "conv_component": lambda: apply_conv_field(x, adv_conv, base, "none", surg),
           "axis_stencil5": lambda: apply_axis_stencil(c5, x),
           "axis_stencil_ext": lambda: apply_axis_stencil_ext(c3, x, (1, 0, 0))}[name]()
    monkeypatch.setattr(advect_mod, "apply_div_field", plain)
    monkeypatch.setattr(advect_mod, "apply_conv_field", plain)
    monkeypatch.setattr(axis_mod, "apply_axis_stencil", plain)
    monkeypatch.setattr(axis_mod, "apply_axis_stencil_ext", plain)
    monkeypatch.setattr(jacobi_mod, "apply_jacobi3d", plain)
    monkeypatch.setattr(jacobi_mod, "apply_jacobi3d_dot", plain)
    fn = {"jacobi3d": lambda: jacobi3d(x, b, inv, 0.0, 1.0, (0, 1, 2)),
          "jacobi3d_dot": lambda: jacobi3d_dot(x, b, inv, 1.0, beta, (0, 1, 2))[0],
          "advect_pair": lambda: advect_pair(x, adv, base, "upwind", surg),
          "conv_component": lambda: conv_component(x, adv_conv, base, "none", surg),
          "axis_stencil5": lambda: axis_stencil5(c5, x),
          "axis_stencil_ext": lambda: axis_stencil_ext(c3, x, (1, 0, 0))}[name]
    _close(fn(), ref, torch.float32)
    torch.cuda.synchronize()


# the halo-extended kernel: (vdim, unextended block) x ext flags, odd sizes
# among them; chip_smoke.py times the 512^3 (4, 2, 1) block
EXT_CASES = [((1, 8, 16, 128), (1, 0, 0)), ((3, 8, 8, 128), (1, 1, 0)),
             ((1, 8, 16, 128), (0, 1, 0)), ((3, 5, 7, 33), (1, 1, 0)),
             ((1, 1, 9, 17), (1, 0, 0)), ((2, 6, 1, 3), (0, 1, 0)), ((1, 4, 4, 4), (0, 0, 0))]


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", range(len(EXT_CASES)))
def test_axis_stencil_ext_matches_plain(cuda, case, dtype, strided):
    """The halo-extended kernel against its plain version on every row,
    written into a new tensor or into a strided view of a larger one (the
    block's view of a global result); one launch each."""
    shape, ext = EXT_CASES[case]
    coeffs, _ = _inputs(shape[1:], 1, dtype, cuda, seed=12)
    g = torch.Generator(device="cpu").manual_seed(13)
    xe = torch.randn((shape[0], *(n + 2 * e for n, e in zip(shape[1:], ext))), generator=g,
                     dtype=torch.float64).to(cuda, dtype)
    out = None
    if strided:
        big = torch.zeros((shape[0] + 1, shape[1] + 3, shape[2] + 2, shape[3]), dtype=dtype,
                          device=cuda)
        out = big[1:, 2:2 + shape[1], 1:1 + shape[2]]
    before = axis_stencil_ext.launches
    got = axis_stencil_ext(coeffs, xe, ext, out=out)
    torch.cuda.synchronize()
    assert axis_stencil_ext.launches == before + 1
    assert out is None or got is out
    _close(got, apply_axis_stencil_ext(coeffs, xe, ext), dtype)
    if strided:
        assert not big[0].any() and not big[:, :2].any() and not big[:, :, 0].any()


@pytest.mark.parametrize("method", ["cg", "mg", "fastdiag"])
def test_cuda_decomposed_solve_matches_cpu(cuda, method):
    """A (4, 2, 1) decomposed solve on the card (f64) equals the CPU run:
    same iterations, and the halo-extended kernel launched on the card."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.parallel import DomainDecomposition
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    nx = [32, 16, 40]
    rhs = np.random.default_rng(14).standard_normal((1, *nx))
    cfg = {"cg": {"method": "cg", "tol": 1e-10, "max_it": 600},
           "mg": {"method": "cg", "precond": "mg", "tol": 1e-10, "max_it": 100,
                  "mg_opts": {"n_pre": 2, "n_post": 2, "omega": 0.857, "fmg": True,
                              "fuse_rz": True}},
           "fastdiag": {"method": "fastdiag", "tol": 1e-10, "max_it": 50}}[method]
    out = []
    for dev in ("cpu", "cuda"):
        mesh = Mesh(Box[0:1, 0:1, 0:1], None, nx, device=dev, dtype="double")
        var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet")}, init_val=0.0)
        s = Solver({"fdm": {**cfg, "criterion": "residual",
                            "decomp": DomainDecomposition((4, 2, 1))}})
        s.set_eq(FDM().laplacian(1.0, var) == torch.from_numpy(rhs).to(dev))
        before = axis_stencil_ext.launches
        rep = s.solve()
        assert rep["converge"]
        assert (axis_stencil_ext.launches > before) == (dev == "cuda")
        out.append((rep["itr"], var()[0].cpu().numpy()))
    assert out[0][0] == out[1][0]
    assert np.abs(out[0][1] - out[1][1]).max() <= 1e-10 * np.abs(out[0][1]).max()


@pytest.mark.parametrize("case", ["burgers_nd", "field_upwind", "const_quick"])
def test_cuda_advection_steps_match_cpu(cuda, case):
    """The implicit-advection models stepped on the card (f64) equal the
    CPU run: same iterations per solve, and the path's kernel launched."""
    from math import pi

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import AdvectionDiffusion, BurgersND
    from pyapes_tpu_torch.variables.bcs import mixed_bcs

    nx = [17, 12, 20]
    rng = np.random.default_rng(11)
    init = [rng.standard_normal((1, *nx)) for _ in range(3)]
    vel = 1.0 + 0.5 * rng.standard_normal((1, *nx))
    bcs = mixed_bcs([0.3, 0.0, 1.0, 0.0, 0.0, -0.2],
                    ["neumann", "dirichlet", "dirichlet", "neumann", "dirichlet", "neumann"])
    kernel = {"burgers_nd": conv_component, "field_upwind": advect_pair,
              "const_quick": axis_stencil5}[case]
    out = []
    for dev in ("cpu", "cuda"):
        if case == "burgers_nd":
            mesh = Mesh(Box[0:2 * pi, 0:2 * pi, 0:2 * pi], None, nx, device=dev, dtype="double")
            model = BurgersND(mesh, nu=0.1, init_vals=init)
            fields = model.vel
        else:
            mesh = Mesh(Box[0:1, 0:1, 0:1], None, nx, device=dev, dtype="double")
            model = AdvectionDiffusion(mesh, bcs, velocity=vel if case == "field_upwind" else 1.0,
                                       epsilon=0.05,
                                       limiter="upwind" if case == "field_upwind" else "quick",
                                       init_val=init[0])
            fields = [model.var]
        before = kernel.launches
        itrs = []
        for _ in range(2):
            model.step(0.01)
            assert model.report["converge"]
            itrs.append(model.report["itr"])
        assert (kernel.launches > before) == (dev == "cuda")
        out.append((itrs, [f()[0].cpu().numpy() for f in fields]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
