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
from pyapes_tpu_torch.ops import diff_field as diff_mod  # noqa: E402
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
# grids whose every plane-march tile lies inside them (n1 % 16 == 0, n1 % 8
# in f64; n2 % 128 == 0): the march's FULL instance, the one the Darcy
# cycle's large levels take, on isotropic Γ
VG_FULL_SHAPES = [(1, 20, 32, 256), (2, 9, 16, 128)]
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
# the axis stencil's plane march and per-point kernel, each forced:
# chip_smoke.py's 3-D kernel and advection shapes (vdim 3, a 3-node axis
# 0), the plane marches' edges and two grids of the march's FULL instance;
# per radius the equations' points per axis (3/5 mixed at radius 2)
AXIS_SHAPES = [(1, 33, 34, 35), (3, 64, 64, 64), (1, 65, 33, 129), (1, 4, 4, 4), (1, 5, 9, 17),
               (3, 3, 9, 11)] + X2_SHAPES + [(1, 20, 32, 256), (3, 9, 16, 128)]
AXIS_POINTS = {1: [(3, 3, 3)], 2: [(5, 3, 5), (5, 5, 5), (3, 5, 3)]}
# the advection kernels' plane march and per-point kernel, each forced, on
# the march's variants (Div central in both forms and upwind; Conv central
# and upwind): the 3-D advection shapes (a 3-node axis 0) and two grids of
# the march's FULL instance
ADV_MARCH_SHAPES = [s for s in ADV_SHAPES if len(s) == 4] + [(1, 20, 32, 256), (3, 9, 16, 128)]
ADV_MARCH_DIV = DIV_VARIANTS[:3]


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


def _axis_inputs(shape, points, dtype, device, seed):
    """x of ``shape`` (vdim first) and per axis ``points`` coefficient
    vectors, made in f64 on the host."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    coeffs = tuple(tuple(torch.randn(n, generator=g, dtype=torch.float64).to(device, dtype)
                         for _ in range(p)) for n, p in zip(shape[1:], points))
    x = torch.randn(shape, generator=g, dtype=torch.float64).to(device, dtype)
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


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", AXIS_SHAPES)
def test_axis_march_and_point_kernels_match_plain(cuda, shape, dtype, radius):
    """``axis_stencil`` (radius 1) and ``axis_stencil5`` (radius 2, mixed
    3/5-point axes): the per-point kernel and the plane march, each forced,
    against the plain version; the march also at explicit plane chunks,
    with the per-point kernel's bits at every chunk; one launch per call."""
    fn = axis_stencil if radius == 1 else axis_stencil5
    for seed, points in enumerate(AXIS_POINTS[radius]):
        coeffs, x = _axis_inputs(shape, points, dtype, cuda, 20 + seed)
        ref = apply_axis_stencil(coeffs, x)
        before = fn.launches
        point = fn(coeffs, x, march=False)
        _close(point, ref, dtype)
        outs = [fn(coeffs, x, march=True, chunk=c) for c in CHUNKS]
        for out in outs:
            _close(out, ref, dtype)
            assert torch.equal(out, point), points  # the per-point kernel's expression
        assert fn.launches == before + 1 + len(CHUNKS)
    torch.cuda.synchronize()


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("march", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_axis_kernels_same_bits_every_call(cuda, dtype, march, radius):
    """Either kernel of either radius gives the same bits on every call."""
    points = (3, 3, 3) if radius == 1 else (5, 3, 5)
    coeffs, x = _axis_inputs((2, 130, 70, 131), points, dtype, cuda, 30)
    fn = axis_stencil if radius == 1 else axis_stencil5
    assert torch.equal(fn(coeffs, x, march=march), fn(coeffs, x, march=march))


def test_axis_march_takes_3d_grids_only(cuda):
    """The plane march takes 3-D grids only: forcing a march on a 1-D grid,
    or at radius 2 on a 2-D grid, raises (it never falls back); on a 2-D
    grid ``axis_stencil``'s ``march=True`` is the row march."""
    coeffs, x = _axis_inputs((1, 65, 130), (3, 3), torch.float32, cuda, 31)
    assert torch.equal(axis_stencil(coeffs, x, march=True), axis_stencil(coeffs, x, march=False))
    with pytest.raises(ValueError):
        axis_stencil5(coeffs, x, march=True)
    coeffs, x = _axis_inputs((2, 300), (3,), torch.float32, cuda, 32)
    with pytest.raises(ValueError):
        axis_stencil(coeffs, x, march=True)


def _path_2d_operators(device, dtype):
    """(label, coeffs, shape) of every 2-D operator of ``chip_smoke.py``'s
    phases 11 and 12 at their cells, in ``dtype``: the rz cell's fine
    Laplacian with and without faces and every rz MG level (512 x 1024),
    the 2D-2 channel's u, v, p Laplacians and every pressure MG level
    (441 x 83)."""
    import chip_smoke as cs

    dtname = str(dtype).split(".")[1]
    ops = [(f"rz {lbl}", c, shp) for lbl, c, shp in cs._rz_operators(device, dtname)]
    ops += [(f"channel {lbl}", tuple(tuple(v.to(dtype) for v in cs_) for cs_ in c), shp)
            for lbl, c, shp in cs._channel_operators(device)]
    return ops


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_march_equals_point_kernel_on_path_operators(cuda, dtype):
    """On every 2-D operator of the rz and channel paths the row march (the
    shape's choice, and forced at explicit row chunks) gives the per-point
    kernel's bits and holds to the plain version; one launch per call."""
    for seed, (label, coeffs, shape) in enumerate(_path_2d_operators(cuda, dtype)):
        g = torch.Generator().manual_seed(40 + seed)
        x = torch.randn((1, *shape), generator=g, dtype=torch.float64).to(cuda, dtype)
        point = axis_stencil(coeffs, x, march=False)
        _close(point, apply_axis_stencil(coeffs, x), dtype)
        before = axis_stencil.launches
        outs = [axis_stencil(coeffs, x)] + [axis_stencil(coeffs, x, march=True, chunk=c)
                                            for c in (1, 3, 64)]
        assert axis_stencil.launches == before + len(outs)
        for out in outs:
            assert torch.equal(out, point), label
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n1", [83, 129, 1023, 3, 1024])
def test_row_march_ragged_widths(cuda, dtype, n1):
    """Rows of no whole 16 bytes, and ``x`` and the axis-1 coefficients at
    an odd element offset (the loads narrow to their alignment): the
    per-point kernel's bits, within the tolerance of the plain version, at
    every chunk, and for an aligned copy of ``x``."""
    coeffs, base = _axis_inputs((2, 37, n1 + 1), (3, 3), dtype, cuda, 50 + n1)
    coeffs = (coeffs[0], tuple(c[1:] for c in coeffs[1]))  # views at an odd offset too
    x = base.reshape(-1)[1:1 + 2 * 37 * n1].view(2, 37, n1)
    ref = apply_axis_stencil(coeffs, x)
    point = axis_stencil(coeffs, x, march=False)
    for chunk in (None, 1, 4, 37):
        out = axis_stencil(coeffs, x, march=True, chunk=chunk)
        _close(out, ref, dtype)
        assert torch.equal(out, point), chunk
    xc = x.clone()
    assert torch.equal(axis_stencil(coeffs, xc), point)


def test_axis_plans_launch_on_the_capture_stream(cuda):
    """Plans built eagerly launch on a CUDA graph's capture stream (a plan
    keeps no stream), and a replay on new data gives the eager bits: the
    row march, the plane march and the alpha-dot."""
    c2, x2 = _axis_inputs((1, 65, 130), (3, 3), torch.float64, cuda, 60)
    c3, x3 = _axis_inputs((1, 20, 32, 256), (3, 3, 3), torch.float32, cuda, 61)
    calls = (lambda: axis_stencil(c2, x2, march=True), lambda: axis_stencil(c3, x3, march=True),
             lambda: axis_stencil_dot(c3, x3, march=True))
    for fn in calls:  # builds the plans
        fn()
    torch.cuda.synchronize()
    before = (axis_stencil.launches, axis_stencil_dot.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for fn in calls]
    assert (axis_stencil.launches, axis_stencil_dot.launches) == (before[0] + 2, before[1] + 1)
    x2.copy_(torch.randn_like(x2))
    x3.copy_(torch.randn_like(x3))
    graph.replay()
    torch.cuda.synchronize()
    eager = [fn() for fn in calls]
    assert torch.equal(outs[0], eager[0]) and torch.equal(outs[1], eager[1])
    assert torch.equal(outs[2][0], eager[2][0]) and torch.equal(outs[2][1], eager[2][1])
    assert (axis_stencil.launches, axis_stencil_dot.launches) == (before[0] + 4, before[1] + 2)


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


def _f64_dot(coeffs, x):
    """The plain version's dot in f64 on the same (rounded) inputs."""
    return apply_axis_stencil_dot(tuple(tuple(c.double() for c in cs) for cs in coeffs),
                                  x.double())[1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", AXIS_SHAPES)
def test_axis_stencil_dot_march_and_point_match_plain(cuda, shape, dtype):
    """The alpha-dot's plane march and per-point kernel, each forced,
    against the plain version: ``A x`` with the per-point kernel's bits at
    every plane chunk; the dot within the tolerance of the plain version's
    f64 dot, with the same bits on every call at a fixed chunk; one launch
    per call."""
    coeffs, x = _axis_inputs(shape, (3, 3, 3), dtype, cuda, 40)
    ref, _ = apply_axis_stencil_dot(coeffs, x)
    ref64 = _f64_dot(coeffs, x)
    before = axis_stencil_dot.launches
    point, pdot = axis_stencil_dot(coeffs, x, march=False)
    _close(point, ref, dtype)
    _dot_close(pdot, ref64, x.double() * ref.double(), dtype)
    for chunk in CHUNKS:
        out, dot = axis_stencil_dot(coeffs, x, march=True, chunk=chunk)
        _close(out, ref, dtype)
        assert torch.equal(out, point), chunk  # the per-point kernel's expression
        _dot_close(dot, ref64, x.double() * ref.double(), dtype)
        again = axis_stencil_dot(coeffs, x, march=True, chunk=chunk)
        assert torch.equal(again[0], out) and torch.equal(again[1], dot), chunk
    assert axis_stencil_dot.launches == before + 1 + 2 * len(CHUNKS)
    torch.cuda.synchronize()


def test_axis_stencil_dot_march_takes_3d_grids_only(cuda):
    """Forcing the alpha-dot's march on a 2-D grid raises; it never falls
    back."""
    coeffs, x = _axis_inputs((1, 65, 130), (3, 3), torch.float32, cuda, 41)
    with pytest.raises(ValueError):
        axis_stencil_dot(coeffs, x, march=True)


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


def _vg_operands(shape, dtype, device, aniso, seed):
    """x, b (``_level``), a Γ in [1, 2) (stacked ``(dim, *nx)`` or
    isotropic) and inv_dx2 of a variable-Γ case."""
    inv, _, x, b = _level(shape, dtype, device, seed)
    nd = len(shape) - 1
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    g = (1.0 + torch.rand(((nd,) if aniso else ()) + shape[1:], generator=gen,
                          dtype=torch.float64)).to(device, dtype)
    return inv, x, b, g


def _vg_call(mode, x, b, g, inv, surg, avg, plain=False, **kw):
    """``diff_field`` (mode "apply") or a ``diff_jacobi`` mode: the wrapper
    with the kernel keywords ``kw``, or with ``plain`` the plain version."""
    nd = len(inv)
    if mode == "apply":
        if plain:
            return apply_diff_field(x, g, inv, surg, avg)
        return diff_field(x, g, inv, surg, avg, **kw)
    xm = None if mode == "smooth0" else x
    if plain:
        return apply_diff_jacobi(xm, b, g, inv, surg, avg, 0.857, tuple(range(nd)), mode)
    return diff_jacobi(xm, b, g, inv, surg, avg, 0.857, tuple(range(nd)), mode, **kw)


@pytest.mark.parametrize("combo", range(len(VG_COMBOS)))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", X2_SHAPES + VG_SHAPES + VG_FULL_SHAPES)
def test_diff_march_and_point_kernels_match_plain(cuda, shape, dtype, combo):
    """Both variable-Γ kernels, each forced at every shape (2-D grids,
    3-node axes and the march's FULL grids too), against the plain versions
    in the four modes; the plane march also at explicit plane chunks, with
    the same bits at every chunk."""
    aniso, avg, neumann = VG_COMBOS[combo]
    inv, x, b, g = _vg_operands(shape, dtype, cuda, aniso, seed=7)
    nd = len(shape) - 1
    mixed = (("neumann", "none"), ("none", "neumann"), ("neumann", "neumann"))
    surg = mixed[:nd] if neumann else (("none", "none"),) * nd
    for mode in ("apply", "smooth", "smooth0", "resid"):
        ref = _vg_call(mode, x, b, g, inv, surg, avg, plain=True)
        _close(_vg_call(mode, x, b, g, inv, surg, avg, march=False), ref, dtype)
        outs = [_vg_call(mode, x, b, g, inv, surg, avg, march=True, chunk=c) for c in CHUNKS]
        for out in outs:
            _close(out, ref, dtype)
            assert torch.equal(out, outs[0]), mode
    torch.cuda.synchronize()


@pytest.mark.parametrize("march", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_diff_kernels_same_bits_every_call(cuda, dtype, march):
    """A variable-Γ kernel gives the same bits on every call (stacked Γ,
    harmonic faces, Neumann surgery: every code path of a point)."""
    inv, x, b, g = _vg_operands((1, 130, 70, 131), dtype, cuda, True, seed=8)
    surg = (("neumann", "none"), ("none", "neumann"), ("neumann", "neumann"))
    for mode in ("apply", "smooth", "smooth0", "resid"):
        one = _vg_call(mode, x, b, g, inv, surg, "harmonic", march=march)
        two = _vg_call(mode, x, b, g, inv, surg, "harmonic", march=march)
        assert torch.equal(one, two), mode


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


# the masks of a torus level: its non-periodic axes (one, two or none)
TORUS_MASKS = [(2,), (0,), (1, 2), ()]


@pytest.mark.parametrize("axes", TORUS_MASKS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 64, 64, 64), (1, 130, 16, 64), (2, 16, 8, 9), (1, 4, 4, 4)])
def test_jacobi_kernels_torus_masks_match_plain(cuda, shape, dtype, axes):
    """The Jacobi family with a periodic level's masks: the torus wrap on
    every axis, the update zeroed on the end rows of ``axes`` only."""
    inv, beta, x, b = _level(shape, dtype, cuda, seed=5)
    for alpha, bt in ((1.0, beta), (0.0, 1.0)):
        _close(jacobi3d(x, b, inv, alpha, bt, axes), apply_jacobi3d(x, b, inv, alpha, bt, axes),
               dtype)
    out, dot = jacobi3d_dot(x, b, inv, 1.0, beta, axes)
    ref, ref_dot = apply_jacobi3d_dot(x, b, inv, 1.0, beta, axes)
    _close(out, ref, dtype)
    _dot_close(dot, ref_dot, b.double() * ref.double(), dtype)
    for zero, emit in ((False, False), (True, True)):
        got = jacobi3d_x2(None if zero else x, b, inv, beta, axes, from_zero=zero, emit_dot=emit)
        ref = apply_jacobi3d_x2(x, b, inv, beta, axes, from_zero=zero, emit_dot=emit)
        if emit:
            _close(got[0], ref[0], dtype)
            _dot_close(got[1], ref[1], b.double() * ref[0].double(), dtype)
        else:
            _close(got, ref, dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_per", [2, 3])
def test_cuda_periodic_mgpcg_matches_cpu(cuda, n_per):
    """MG-PCG on a 65^3-node box with the first ``n_per`` axes periodic
    (the 64^3-point torus levels; all three: the singular torus, the
    zero-mean RHS), bench's cycle in f64: on the card the same iterations
    as on the CPU, the solution within 1e-10, the Jacobi kernels launched."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import mixed_bcs

    kinds = ["periodic"] * (2 * n_per) + ["dirichlet"] * (6 - 2 * n_per)
    bcs = mixed_bcs([None if k == "periodic" else 0.0 for k in kinds], kinds)
    rhs = np.random.default_rng(8).standard_normal((1, 65, 65, 65))
    cfg = {"method": "cg", "precond": "mg", "tol": 1e-10, "max_it": 100,
           "criterion": "residual",
           "mg_opts": {"n_pre": 2, "n_post": 2, "omega": 0.857, "fmg": True, "fuse_rz": True}}
    if n_per == 3:
        rhs -= rhs[:, :-1, :-1, :-1].mean()
        cfg["nullspace"] = "mean"
    out = []
    for dev in ("cpu", "cuda"):
        mesh = Mesh(Box[0:1, 0:1, 0:1], None, [65] * 3, device=dev, dtype="double")
        var = Field("p", 1, mesh, {"domain": bcs}, init_val=0.0)
        s = Solver({"fdm": dict(cfg)})
        s.set_eq(FDM().laplacian(1.0, var) == torch.from_numpy(rhs).to(dev))
        before = (jacobi3d.launches, jacobi3d_x2.launches)
        rep = s.solve()
        assert rep["converge"]
        if dev == "cuda":
            assert jacobi3d.launches > before[0] and jacobi3d_x2.launches > before[1]
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


@pytest.mark.parametrize("kind", sorted(ADV_SURGERY))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ADV_MARCH_SHAPES)
def test_advect_march_and_point_kernels_match_plain(cuda, shape, dtype, kind):
    """``advect_pair`` (central in both forms and upwind, vector and scalar
    targets) and ``conv_component`` (central and upwind): the per-point
    kernel and the plane march, each forced, against the plain version;
    the march also at explicit plane chunks, with the per-point kernel's
    bits at every chunk; one launch per call."""
    x, adv, adv_conv, base, _ = _adv_inputs(shape, dtype, cuda, 12)
    surg = ADV_SURGERY[kind]
    cases = [(advect_pair, (xs, av, base, limiter, surg, form),
              lambda xs=xs, av=av, limiter=limiter, form=form:
              apply_div_field(xs, av, base, limiter, surg, form))
             for limiter, form in ADV_MARCH_DIV for xs, av in ((x, adv), (x[:1], adv[:1]))]
    cases += [(conv_component, (x, adv_conv, base, limiter, surg),
               lambda limiter=limiter: apply_conv_field(x, adv_conv, base, limiter, surg))
              for limiter in ("none", "upwind")]
    for fn, args, plain in cases:
        ref = plain()
        before = fn.launches
        point = fn(*args, march=False)
        _close(point, ref, dtype)
        for c in CHUNKS:
            out = fn(*args, march=True, chunk=c)
            _close(out, ref, dtype)
            assert torch.equal(out, point), (fn.__name__, args[3:])  # the per-point expression
        assert fn.launches == before + 1 + len(CHUNKS)
    torch.cuda.synchronize()


@pytest.mark.parametrize("march", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_advect_kernels_same_bits_every_call(cuda, dtype, march):
    """Either kernel gives the same bits on every call (Div upwind and
    central conservative, Conv central)."""
    x, adv, adv_conv, base, _ = _adv_inputs((3, 70, 32, 131), dtype, cuda, 13)
    surg = ADV_SURGERY["mixed"]
    for call in (lambda: advect_pair(x[:1], adv[:1], base, "upwind", surg, march=march),
                 lambda: advect_pair(x, adv, base, "none", surg, "conservative", march=march),
                 lambda: conv_component(x, adv_conv, base, "none", surg, march=march)):
        assert torch.equal(call(), call())


def test_advect_march_takes_3d_central_or_upwind_only(cuda):
    """Forcing the march on a 2-D grid or with QUICK raises; it never falls
    back."""
    x, adv, adv_conv, base, _ = _adv_inputs((1, 65, 130), torch.float32, cuda, 14)
    surg = ADV_SURGERY["none"][:2]
    with pytest.raises(ValueError):
        advect_pair(x, adv, base, "upwind", surg, march=True)
    x, adv, adv_conv, base, _ = _adv_inputs((1, 9, 16, 128), torch.float32, cuda, 14)
    with pytest.raises(ValueError):
        conv_component(x, adv_conv, base, "quick", ADV_SURGERY["none"], march=True)


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


@pytest.mark.parametrize("name", ["advect_pair", "conv_component", "advect_pair_march",
                                  "advect_pair_point", "conv_component_march",
                                  "conv_component_point", "axis_stencil5",
                                  "axis_stencil_ext", "jacobi3d", "jacobi3d_dot",
                                  "diff_field_march", "diff_field_point", "diff_jacobi_march",
                                  "diff_jacobi_point", "axis_stencil_march", "axis_stencil_point",
                                  "axis_stencil5_march", "axis_stencil5_point",
                                  "axis_stencil_dot", "axis_stencil_dot_march",
                                  "axis_stencil_dot_point", "axis_stencil_ext_march",
                                  "axis_stencil_ext_point", "jacobi3d_x2"])
def test_cuda_tensor_never_reaches_the_plain_version(cuda, name, monkeypatch):
    """With the plain versions patched to raise, the wrappers still answer
    a CUDA tensor: from the kernel."""
    def plain(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    x, adv, adv_conv, base, c5 = _adv_inputs((1, 9, 10, 11), torch.float32, cuda, 10)
    c3 = tuple(tuple(c[:n - 2] for c in cs[:3]) if j == 0 else cs[:3]
               for j, (cs, n) in enumerate(zip(c5, x.shape[1:])))
    c3x = tuple(cs[1:4] if len(cs) == 5 else cs for cs in c5)  # 3-point, x's shape
    surg = ADV_SURGERY["mixed"]
    surg3 = (("neumann", "none"), ("none", "neumann"), ("neumann", "neumann"))
    inv, beta, _, b = _level(tuple(x.shape), torch.float32, cuda, seed=11)
    gv = (b.abs() + 1.0)[0]  # a variable Γ
    ref = {"jacobi3d": lambda: apply_jacobi3d(x, b, inv, 0.0, 1.0, (0, 1, 2)),
           "jacobi3d_dot": lambda: apply_jacobi3d_dot(x, b, inv, 1.0, beta, (0, 1, 2))[0],
           "advect_pair": lambda: apply_div_field(x, adv, base, "upwind", surg),
           "conv_component": lambda: apply_conv_field(x, adv_conv, base, "none", surg),
           "axis_stencil5": lambda: apply_axis_stencil(c5, x),
           "axis_stencil": lambda: apply_axis_stencil(c3x, x),
           "axis_stencil_dot": lambda: apply_axis_stencil_dot(c3x, x)[0],
           "jacobi3d_x2": lambda: apply_jacobi3d_x2(x, b, inv, beta, (0, 1, 2)),
           "axis_stencil_ext": lambda: apply_axis_stencil_ext(c3, x, (1, 0, 0)),
           "diff_field": lambda: apply_diff_field(x, gv, inv, surg3, "harmonic"),
           "diff_jacobi": lambda: apply_diff_jacobi(x, b, gv, inv, surg3, "harmonic", 0.857,
                                                    (0, 1, 2), "smooth"),
           }[name.replace("_march", "").replace("_point", "")]()
    monkeypatch.setattr(advect_mod, "apply_div_field", plain)
    monkeypatch.setattr(advect_mod, "apply_conv_field", plain)
    monkeypatch.setattr(axis_mod, "apply_axis_stencil", plain)
    monkeypatch.setattr(axis_mod, "apply_axis_stencil_ext", plain)
    monkeypatch.setattr(axis_mod, "apply_axis_stencil_dot", plain)
    monkeypatch.setattr(jacobi_mod, "apply_jacobi3d", plain)
    monkeypatch.setattr(jacobi_mod, "apply_jacobi3d_dot", plain)
    monkeypatch.setattr(jacobi_mod, "apply_jacobi3d_x2", plain)
    monkeypatch.setattr(diff_mod, "apply_diff_field", plain)
    monkeypatch.setattr(diff_mod, "apply_diff_jacobi", plain)
    # the kernel forced by the name's suffix; a bare name: the shape's choice
    march = {"_march": True, "_point": False}.get(name[name.rfind("_"):])
    fn = {"jacobi3d": lambda: jacobi3d(x, b, inv, 0.0, 1.0, (0, 1, 2)),
          "jacobi3d_dot": lambda: jacobi3d_dot(x, b, inv, 1.0, beta, (0, 1, 2))[0],
          "advect_pair": lambda: advect_pair(x, adv, base, "upwind", surg, march=march),
          "conv_component": lambda: conv_component(x, adv_conv, base, "none", surg,
                                                   march=march),
          "axis_stencil5": lambda: axis_stencil5(c5, x, march=march),
          "axis_stencil": lambda: axis_stencil(c3x, x, march=march),
          "axis_stencil_dot": lambda: axis_stencil_dot(c3x, x, march=march)[0],
          "jacobi3d_x2": lambda: jacobi3d_x2(x, b, inv, beta, (0, 1, 2)),
          "axis_stencil_ext": lambda: axis_stencil_ext(c3, x, (1, 0, 0), march=march),
          "diff_field": lambda: diff_field(x, gv, inv, surg3, "harmonic", march=march),
          "diff_jacobi": lambda: diff_jacobi(x, b, gv, inv, surg3, "harmonic", 0.857, (0, 1, 2),
                                             "smooth", march=march),
          }[name.replace("_march", "").replace("_point", "")]
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


# the halo-extended march's own cases: blocks whose every tile lies inside
# them (its FULL instance) besides EXT_CASES' odd ones
EXT_MARCH_CASES = EXT_CASES + [((2, 9, 32, 256), (1, 1, 0)), ((1, 6, 16, 128), (0, 1, 0))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", range(len(EXT_MARCH_CASES)))
def test_axis_stencil_ext_march_and_point_match_plain(cuda, case, dtype):
    """The halo-extended apply's plane march and per-point kernel, each
    forced, against the plain version: into a new tensor, a strided view
    that takes pair stores and one at an odd offset that does not; the
    march with the per-point kernel's bits at every plane chunk, writing
    nothing outside its view; one launch per call."""
    shape, ext = EXT_MARCH_CASES[case]
    coeffs, _ = _inputs(shape[1:], 1, dtype, cuda, seed=42)
    g = torch.Generator(device="cpu").manual_seed(43)
    xe = torch.randn((shape[0], *(n + 2 * e for n, e in zip(shape[1:], ext))), generator=g,
                     dtype=torch.float64).to(cuda, dtype)
    ref = apply_axis_stencil_ext(coeffs, xe, ext)
    before = axis_stencil_ext.launches
    point = axis_stencil_ext(coeffs, xe, ext, march=False)
    _close(point, ref, dtype)
    calls = 1
    for off in (0, 1):  # the view's offset along the last axis: even (pairs), odd
        big = torch.zeros((shape[0] + 1, shape[1] + 2, shape[2] + 3, shape[3] + 2), dtype=dtype,
                          device=cuda)
        view = big[1:, 1:1 + shape[1], 2:2 + shape[2], off:off + shape[3]]
        assert axis_mod.pair_stores(view) is (off == 0 and shape[3] % 2 == 0)
        for chunk in CHUNKS:
            big.zero_()
            got = axis_stencil_ext(coeffs, xe, ext, out=view, march=True, chunk=chunk)
            assert got is view
            _close(got, ref, dtype)
            assert torch.equal(got, point), (off, chunk)
            view.zero_()
            assert not big.any(), (off, chunk)  # nothing written outside the view
            calls += 1
    assert torch.equal(axis_stencil_ext(coeffs, xe, ext, march=True), point)
    assert axis_stencil_ext.launches == before + calls + 1
    torch.cuda.synchronize()


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


def _cavity_run(dev, model_name, nx, steps, dt):
    """``steps`` eager steps of the cavity (``model_name`` "cavity": 3-D
    f64, nu 0.01, regularized lid; "convection": 2-D Ra 1e3) on ``dev``:
    ``(itr per solve, the state fields as numpy)``."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import LidDrivenCavity, NaturalConvection

    mesh = Mesh(Box[tuple(slice(0, 1) for _ in nx)], None, list(nx), device=dev,
                dtype="double")
    if model_name == "cavity":
        model = LidDrivenCavity(mesh, nu=0.01, lid_profile="regularized")
    else:
        model = NaturalConvection(mesh, ra=1e3, pr=0.71)
    itrs = []
    for solver in (model.mom_solver, model.p_solver):
        real = solver.solve

        def solve(real=real):
            rep = real()
            assert rep["converge"]
            itrs.append(rep["itr"])
            return rep

        solver.solve = solve
    model.run(dt, steps)
    return itrs, [f()[0].cpu().numpy() for f in model.state_fields()]


@pytest.mark.parametrize("case", ["cavity", "convection"])
def test_cuda_cavity_steps_match_cpu(cuda, case):
    """The lid-driven cavity (33^3 f64, 10 steps: fastdiag momentum and
    pressure, the axis-stencil kernel in every residual) and the
    convection cavity (33^2, 3 steps: BiCGSTAB with the FD preconditioner
    through the convection kernel) on the card equal the CPU run: the same
    itr solve by solve, the fields within 1e-10 relative."""
    nx, steps, dt = ((33, 33, 33), 10, 0.25 / 128) if case == "cavity" else ((33, 33), 3, 0.0125)
    kernel = axis_stencil if case == "cavity" else conv_component
    cpu = _cavity_run("cpu", case, nx, steps, dt)
    before = kernel.launches
    card = _cavity_run("cuda", case, nx, steps, dt)
    assert kernel.launches > before
    assert card[0] == cpu[0]
    for a, b in zip(cpu[1], card[1]):
        assert np.abs(a - b).max() <= 1e-10 * max(np.abs(a).max(), 1e-30)


def _rz_operators(device, dtype, shape=(64, 128)):
    """The rz path's axis-stencil operators on a Cylinder[0:4, -4:4] grid:
    the Laplacian with the potentials' faces (r = 0 symmetry surgery,
    Dirichlet at ru and on z), without faces (the raw r = 0 row), and every
    level of the rz V-cycle."""
    from pyapes_tpu_torch.geometry import Cylinder
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.ops.stencil import laplacian_axis_coeffs
    from pyapes_tpu_torch.solver.multigrid import MGSpec
    from pyapes_tpu_torch.utils.carry import coeffs_from_numpy
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import CylinderBoundary

    mesh = Mesh(Cylinder[0:4, -4:4], None, list(shape), device="cpu", dtype="double")
    bcs = CylinderBoundary(rl={"bc_type": "symmetry", "bc_val": None},
                           **{f: {"bc_type": "dirichlet", "bc_val": 0.0}
                              for f in ("ru", "zl", "zu")})()
    var = Field("h", 1, mesh, {"domain": bcs})
    ops = [(coeffs_from_numpy(laplacian_axis_coeffs(mesh, b), device, dtype), shape)
           for b in (var.bcs, None)]
    spec = MGSpec(shape, (4.0, 8.0), rz=True, dtype=dtype, device=device,
                  face_kinds=(("neumann", "dirichlet"), ("dirichlet", "dirichlet")))
    return ops + [(spec._level_coeffs(s), s) for s in spec.shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_axis_stencil_rz_matches_plain(cuda, dtype):
    """The 2-D kernel of the shape's choice (the row march) on the rz
    vectors (the fine operator with and without faces, every rz MG level):
    within the tolerance, the same bits on another call, one launch each."""
    for seed, (coeffs, shape) in enumerate(_rz_operators(cuda, dtype)):
        x = torch.randn((1, *shape), generator=torch.Generator().manual_seed(seed),
                        dtype=torch.float64).to(cuda, dtype)
        before = axis_stencil.launches
        out = axis_stencil(coeffs, x)
        assert axis_stencil.launches == before + 1
        assert torch.equal(out, axis_stencil(coeffs, x))
        _close(out, apply_axis_stencil(coeffs, x), dtype)


@pytest.mark.parametrize("case", ["steps", "potentials_mg"])
def test_cuda_rz_path_matches_cpu(cuda, case):
    """The rz path in f64 on the card equals the CPU run: three implicit
    RFP steps (``tests/test_models.py``'s 32 x 48 problem, the FD
    preconditioner of the hint), or the Rosenbluth potentials under
    BiCGSTAB with the rz V-cycle (the axis-stencil kernel on every level):
    the same itr solve by solve, the fields within 1e-10 relative."""
    from pyapes_tpu_torch.geometry import Cylinder
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import RFPEvolution, RosenbluthPotentials
    from pyapes_tpu_torch.variables import Field

    def run(device):
        mesh = Mesh(Cylinder[0:3, -3:3], None, [32, 48], device=device, dtype="double")
        R, Z = mesh.R, mesh.Z
        f0 = torch.exp(-(R**2 + Z**2) / 1.28)
        if case == "potentials_mg":
            pots = RosenbluthPotentials(mesh, f0, {"method": "bicgstab", "precond": "mg"})
            out = pots.solve(f0)
            return [r["itr"] for r in pots.reports], [t.cpu().numpy() for t in out]
        model = RFPEvolution(mesh, -torch.sqrt(R**2 + Z**2 + 0.5), torch.sqrt(R**2 + Z**2 + 0.5))
        f, itrs = Field("pdf", 1, mesh, None).set_var_tensor(f0), []
        for _ in range(3):
            f = model.step_implicit(f, 2e-3)
            itrs.append(model.report["itr"])
        return itrs, [f().cpu().numpy()]

    cpu = run("cpu")
    before = axis_stencil.launches
    card = run("cuda")
    if case == "potentials_mg":
        assert axis_stencil.launches > before
    assert card[0] == cpu[0]
    for a, b in zip(cpu[1], card[1]):
        assert np.abs(a - b).max() <= 1e-10 * max(np.abs(a).max(), 1e-30)


@pytest.mark.parametrize("case", ["cylinder_channel", "dirichlet_body_mg"])
def test_cuda_obstacle_path_matches_cpu(cuda, case):
    """The channel path in f64 on the card equals the CPU run: the cylinder
    channel of ``tests/test_obstacle.py`` (97 x 33, 10 eager steps: plain
    BiCGSTAB momentum, BiCGSTAB with the plain-domain V-cycle on the
    obstacle pressure), or a hot square body's Laplace solve by MG-PCG:
    the same itr solve by solve, the fields within 1e-10 relative, the
    axis stencil launched on the card, and the device forces equal to the
    host ones."""
    from pyapes_tpu_torch.geometry import Box, MaskObstacle
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import ChannelFlow
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    def run(device):
        if case == "dirichlet_body_mg":
            mesh = Mesh(Box[0:1, 0:1], [Box[0.4:0.6, 0.4:0.6]], [65, 65], device=device,
                        dtype="double")
            var = Field("p", 1, mesh, {"domain": homogeneous_bcs(2, 0.0, "dirichlet"),
                                       "obstacle": [{"bc_type": "dirichlet", "bc_val": 1.0}]})
            s = Solver({"fdm": {"method": "cg", "precond": "mg", "tol": 1e-10, "max_it": 500,
                                "criterion": "residual"}})
            s.set_eq(FDM().laplacian(1.0, var) == torch.zeros_like(var()))
            return [s.solve()["itr"]], [var().cpu().numpy()], None
        body = MaskObstacle(lambda X, Y: (X - 0.7) ** 2 + (Y - 0.5) ** 2 < 0.12**2)
        mesh = Mesh(Box[0:3, 0:1], [body], [97, 33], device=device, dtype="double")
        model = ChannelFlow(mesh, nu=0.02, u_in=1.0)
        itrs = []
        for solver in (model.mom_solver, model.p_solver):
            def solve(real=solver.solve):
                rep = real()
                itrs.append(rep["itr"])
                return rep

            solver.solve = solve
        model.run(0.005, 10)
        forces = (model.body_force(), model.body_force_device().cpu().numpy(),
                  model.body_force_cv(), model.body_force_cv_device().cpu().numpy())
        return itrs, [f().cpu().numpy() for f in model.state_fields()], forces

    cpu = run("cpu")
    before = axis_stencil.launches
    card = run("cuda")
    assert axis_stencil.launches > before
    assert card[0] == cpu[0]
    for a, b in zip(cpu[1], card[1]):
        assert np.abs(a - b).max() <= 1e-10 * max(np.abs(a).max(), 1e-30)
    if card[2] is not None:
        for a, b in zip(cpu[2], card[2]):
            assert np.abs(a - b).max() <= 1e-10 * max(np.abs(a).max(), 1e-30)


# -- the device loop, sync: False solves and the fused step ------------------


class _Poisson:
    """A 17^3 f64 Poisson problem on ``device`` (Dirichlet faces, random RHS
    from a seed), built once: ``solve(method, sync)`` by "fastdiag", "cg"
    (+ the MG V-cycle) or "bicgstab" (+ the FD preconditioner) from ``x0``
    (zeros by default); returns (solution, report)."""

    def __init__(self, device, n: int = 17):
        from pyapes_tpu_torch.geometry import Box
        from pyapes_tpu_torch.mesh import Mesh
        from pyapes_tpu_torch.solver.fdm import FDM
        from pyapes_tpu_torch.variables import Field
        from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

        mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n, n, n], device=device, dtype="double")
        self.var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet")})
        self.rhs = torch.as_tensor(np.random.default_rng(3).standard_normal((1, n, n, n)),
                                   device=device)
        self.zeros = torch.zeros_like(self.var())
        self.fdm = FDM()

    def solve(self, method, sync, x0=None, tol=1e-10, max_it=200):
        from pyapes_tpu_torch.solver.ops import Solver

        self.var.VAR = self.zeros if x0 is None else x0
        cfg = {"method": method, "tol": tol, "max_it": max_it, "criterion": "residual",
               "sync": sync, "history": True}
        cfg.update({"cg": {"precond": "mg"}, "bicgstab": {"precond": "fd"}}.get(method, {}))
        s = Solver({"fdm": cfg})
        s.set_eq(self.fdm.laplacian(1.0, self.var) == self.rhs)
        return self.var().clone(), s.solve()


@pytest.mark.parametrize("method", ["fastdiag", "cg", "bicgstab"])
def test_cuda_sync_false_solve_replays_eager(cuda, method):
    """A ``sync: False`` solve is a graph of the whole call: the first call
    runs eagerly and captures it, the next ones replay it. Both equal the
    ``sync: True`` solve (1e-12 relative, the same itr and history), and a
    replay makes no host sync (``set_sync_debug_mode("error")``)."""
    from pyapes_tpu_torch.ops import graph_loop

    prob = _Poisson(cuda)
    x_ref, rep = prob.solve(method, True)
    x1, rep1 = prob.solve(method, False)
    nodes = graph_loop.nodes
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x2, rep2 = prob.solve(method, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert graph_loop.nodes == nodes  # replayed, not captured again
    scale = float(x_ref.abs().max())
    for x, r in ((x1, rep1), (x2, rep2)):
        assert float((x - x_ref).abs().max()) <= 1e-12 * scale
        assert int(r["itr"]) == rep["itr"]
        assert float(r["tol"]) == pytest.approx(rep["tol"], rel=1e-12, abs=0.0)
        hist = r["history"].cpu().numpy()
        np.testing.assert_array_equal(hist[:rep["itr"]], rep["history"])
        assert np.isnan(hist[rep["itr"]:]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["tol", "tol_stall", "stop"])
def test_loop_record_matches_plain(cuda, dtype, mode):
    """The bookkeeping kernel of a solver loop's pass equals its plain
    version on the CPU, state for state: the history, the float64
    tolerance, the count and the condition, through a run that contracts,
    stalls (ratio 0.5), meets the tolerance, is stopped or reaches
    ``max_it``."""
    from pyapes_tpu_torch.ops.graph_loop import loop_record

    max_it = 6
    ts = [0.3, 0.04, 0.03, 2e-3, 5e-7, 4e-7, 1e-8]
    stops = [False, False, True, False, False, True, False]
    states = {}
    for dev in ("cpu", cuda):
        states[dev] = [torch.ones((), dtype=torch.float64, device=dev),
                       torch.zeros((), dtype=torch.int64, device=dev),
                       torch.full((max_it,), float("nan"), dtype=torch.float32, device=dev),
                       torch.ones((), dtype=torch.bool, device=dev)]
    for t, stop in zip(ts[:max_it], stops):
        for dev, (tol, itr, hist, go) in states.items():
            kw = {"tol": {"tolerance": 1e-6}, "tol_stall": {"tolerance": 1e-6, "stall_ratio": 0.5},
                  "stop": {"stop": torch.tensor(stop, device=dev)}}[mode]
            loop_record(torch.tensor(t, dtype=dtype, device=dev), tol, itr, hist, go, max_it, **kw)
        for a, b in zip(states["cpu"], states[cuda]):
            assert torch.equal(a, b.cpu()) or (a.dtype == torch.float32
                                                and torch.equal(a.isnan(), b.cpu().isnan())
                                                and torch.equal(a.nan_to_num(), b.cpu().nan_to_num()))


def test_cuda_while_loop_trip_counts(cuda):
    """The WHILE node runs zero passes on a converged start (the solution
    itself as x0, a tolerance already met) and exactly ``max_it`` when the
    tolerance is never met (0)."""
    prob = _Poisson(cuda)
    x_ref, _ = prob.solve("cg", True)
    for x0, tol, max_it, want in ((None, 0.0, 7, 7), (x_ref, 1.0, 50, 0)):
        for _ in range(2):  # the eager first call, then the replay
            _, rep = prob.solve("cg", False, x0=x0, tol=tol, max_it=max_it)
            assert int(rep["itr"]) == want


def _fused_models(case, device):
    """Two models of ``case`` on ``device`` (f64): the 17^3 cavity, the
    49 x 25 channel past a cylinder, the 17^3 Smagorinsky TGV."""
    from math import pi

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.geometry.mask import MaskObstacle
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import ChannelFlow, LidDrivenCavity, PeriodicFlow
    from pyapes_tpu_torch.models.navier_stokes import smagorinsky_viscosity

    def make():
        if case == "cavity":
            mesh = Mesh(Box[0:1, 0:1, 0:1], None, [17] * 3, device=device, dtype="double")
            return LidDrivenCavity(mesh, nu=0.01, lid_profile="regularized"), 0.25 / 16
        if case == "channel":
            body = lambda X, Y: (X - 0.7) ** 2 + (Y - 0.5) ** 2 < 0.14**2  # noqa: E731
            mesh = Mesh(Box[0:2, 0:1], [MaskObstacle(body)], [49, 25], device=device,
                        dtype="double")
            return ChannelFlow(mesh, nu=0.05, u_in=1.0), 0.005
        mesh = Mesh(Box[0:2 * pi, 0:2 * pi, 0:2 * pi], None, [17] * 3, device=device,
                    dtype="double")
        m = PeriodicFlow(mesh, nu=1 / 1600, mu_strain_fn=smagorinsky_viscosity(1 / 1600, mesh))
        X, Y, Z = mesh.grid
        m.set_velocity(torch.sin(X) * torch.cos(Y) * torch.cos(Z),
                       -torch.cos(X) * torch.sin(Y) * torch.cos(Z), torch.zeros_like(X))
        return m, 0.05

    return make(), make()


@pytest.mark.parametrize("case", ["cavity", "channel", "tgv"])
def test_cuda_fused_step_matches_eager(cuda, case):
    """A fused step on the card is one graph replay whose solver loops are
    WHILE nodes; it equals the eager step (1e-12 relative) with the same
    itr solve by solve, and its replays make no host sync."""
    from pyapes_tpu_torch.ops import graph_loop
    from pyapes_tpu_torch.solver.ops import solve_log

    (m1, dt), (m2, _) = _fused_models(case, cuda)
    m1.run(dt, 2)
    nodes = graph_loop.nodes
    m2.run(dt, 2, fused=True)  # the second step captures the steady graph
    runner = m2.fused_runner()
    assert runner.captures == 1 and graph_loop.nodes > nodes
    for _ in range(3):
        with solve_log() as log:
            m1.step(dt)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            runner.step(dt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert [int(r["itr"]) for r in runner.reports] == [int(r["itr"]) for r in log]
    assert runner.captures == 1
    for a, b in zip(m1.state_fields(), m2.state_fields()):
        scale = max(float(a().abs().max()), 1e-30)
        assert float((a() - b()).abs().max()) <= 1e-12 * scale, a.name
        assert a.n_hist == b.n_hist and a._dt == b._dt


def test_cuda_fused_streams_dt_one_capture_each(cuda):
    """``dt`` is baked into the port's step graph: each distinct ``dt`` is
    one capture (three here), where the JAX program streams it; the states
    stay equal to the eager sequence."""
    (m1, _), (m2, _) = _fused_models("cavity", cuda)
    seq = [0.01, 0.01, 0.02, 0.005, 0.01, 0.02, 0.01]
    for dt in seq:
        m1.step(dt)
    m2.step(seq[0])
    m2.step(seq[1])
    runner = m2.fused_runner()
    for dt in seq[2:]:
        runner.step(dt)
    assert runner.captures == 3
    for a, b in zip(m1.state_fields(), m2.state_fields()):
        assert float((a() - b()).abs().max()) <= 1e-12 * max(float(a().abs().max()), 1e-30)


def _overwrite_freed_memory(device) -> list:
    """NaN-filled float64 tensors of many sizes (8 B to 1.6 MB, log-uniform),
    allocated where the caching allocator has freed blocks: a graph that
    still reads freed memory then reads NaN. Returned to hold them."""
    import gc

    gc.collect()
    rng = np.random.default_rng(0)
    return [torch.full((int(n),), float("nan"), dtype=torch.float64, device=device)
            for n in np.exp(rng.uniform(0.0, np.log(2e5), 4000))]


def test_cuda_graphs_outlive_cache_eviction(cuda):
    """A captured ``sync: False`` solve (CG + MG) and a captured fused
    cavity step keep what they read alive. After 9 other multigrid
    hierarchies and 17 other eigen-factorizations, then a cleared
    device-constant cache, then ``clear_cache()``, each time with the freed
    memory overwritten, the replays still equal the eager solves and steps
    (1e-12 relative, the same itr)."""
    from pyapes_tpu_torch.ops import graph_loop
    from pyapes_tpu_torch.solver.linalg import build
    from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache
    from pyapes_tpu_torch.solver.ops import solve_log
    from pyapes_tpu_torch.utils import device_cache

    clear_cache()
    prob = _Poisson(cuda)
    x_ref, rep = prob.solve("cg", True)
    prob.solve("cg", False)  # warm-up and capture
    (m1, dt), (m2, _) = _fused_models("cavity", cuda)
    m1.run(dt, 2)
    m2.run(dt, 2, fused=True)
    runner = m2.fused_runner()

    def check_steps():
        for _ in range(2):
            with solve_log() as log:
                m1.step(dt)
            runner.step(dt)
            assert [int(r["itr"]) for r in runner.reports] == [int(r["itr"]) for r in log]
        for a, b in zip(m1.state_fields(), m2.state_fields()):
            scale = max(float(a().abs().max()), 1e-30)
            assert float((a() - b()).abs().max()) <= 1e-12 * scale, a.name
        assert runner.captures == 1

    for n in range(5, 5 + build._FD_CACHE_MAX + 1):
        _Poisson(cuda, n).solve("fastdiag", True)
    for n in range(5, 5 + build._MG_CACHE_MAX + 1):
        _Poisson(cuda, n).solve("cg", True)
    junk = _overwrite_freed_memory(cuda)
    nodes = graph_loop.nodes
    x, r = prob.solve("cg", False)
    assert graph_loop.nodes == nodes  # a replay of the first capture
    assert float((x - x_ref).abs().max()) <= 1e-12 * float(x_ref.abs().max())
    assert int(r["itr"]) == rep["itr"]
    check_steps()
    for evict in (device_cache.clear, clear_cache):
        del junk
        evict()
        junk = _overwrite_freed_memory(cuda)
        check_steps()


def test_cuda_fused_fallback_on_host_read_bc(cuda):
    """A lid callable that reads ``float(t)`` cannot be captured:
    ``run(fused=True)`` warns and falls back to eager steps, the state
    untouched (JAX ``test_fuse.py:73``)."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import LidDrivenCavity

    def lid(t):
        return float(t) * 0.0 + 1.0

    def make():
        mesh = Mesh(Box[0:1, 0:1], None, [17, 17], device=cuda, dtype="double")
        return LidDrivenCavity(mesh, nu=0.05, lid_velocity=lid)

    m1, m2 = make(), make()
    m1.run(0.01, 8)
    with pytest.warns(UserWarning, match="falling back to eager"):
        m2.run(0.01, 8, fused=True)
    for a, b in zip(m1.state_fields(), m2.state_fields()):
        assert float((a() - b()).abs().max()) <= 1e-12 * max(float(a().abs().max()), 1e-30)


# -- the adjoint tier and checkpoints ------------------------------------------

def _adjoint_case(kind, device, n=17):
    """``(forward(param) -> solution, param0, loss weight)`` of one adjoint
    class on a 3-D ``n^3`` f64 box on ``device``; the same seeded inputs
    on every device."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.ops.stencil import laplacian_axis_coeffs
    from pyapes_tpu_torch.solver.adjoint import (
        DifferentiableDiffusionSolve,
        DifferentiableSolve,
        DifferentiableTransient,
        DifferentiableTransientDiffusion,
    )
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs, mixed_bcs

    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device=device, dtype="double")
    rng = np.random.default_rng(11)

    def bcs_of(cfg):
        return Field("p", 1, mesh, {"domain": cfg, "obstacle": None}).bcs

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    rhs = t(rng.standard_normal((1, n, n, n)))
    weight = t(rng.standard_normal((1, n, n, n)))
    gamma = t(1.0 + 0.5 * rng.random((n, n, n)))
    dirichlet = bcs_of(homogeneous_bcs(3, 0.0, "dirichlet"))
    lap = tuple(tuple(t(c) for c in cs) for cs in laplacian_axis_coeffs(mesh, dirichlet))
    if kind == "solve":
        ds = DifferentiableSolve(mesh, dirichlet, tol=1e-12)
        coeffs = tuple((ap, ac + (20.0 if j == 0 else 0.0), am - 3.0 * ap)
                       for j, (ap, ac, am) in enumerate(lap))
        return (lambda b: ds(coeffs, b)), rhs, weight
    if kind in ("diffusion", "diffusion_neumann"):
        if kind == "diffusion":
            ds = DifferentiableDiffusionSolve(mesh, dirichlet, tol=1e-12, symmetric=True)
        else:
            bcs = bcs_of(mixed_bcs([0.0] * 6, ["neumann", "dirichlet", "dirichlet", "neumann",
                                               "dirichlet", "dirichlet"]))
            ds = DifferentiableDiffusionSolve(mesh, bcs, tol=1e-12, avg="harmonic")
        return (lambda g: ds(g, rhs)), gamma, weight
    if kind == "transient":
        roll = DifferentiableTransient(
            mesh, dirichlet, lambda nu: tuple((-nu * ap, -nu * ac, -nu * am)
                                              for ap, ac, am in lap), dt=0.02, tol=1e-12)
        return (lambda nu: roll(nu, rhs, 3)), t(0.05), weight
    roll = DifferentiableTransientDiffusion(mesh, dirichlet, dt=0.02, tol=1e-12)
    return (lambda g: roll(g, rhs, 3)), gamma, weight


def _value_and_grad(forward, p0, weight):
    """The solution and the gradient of ``sum(w x) + sum(x^2)``."""
    p = p0.detach().clone().requires_grad_(True)
    x = forward(p)
    (g,) = torch.autograd.grad(torch.sum(weight * x) + torch.sum(x * x), p)
    return x.detach().cpu(), g.cpu()


@pytest.mark.parametrize("kind", ["solve", "diffusion", "diffusion_neumann", "transient",
                                  "transient_diffusion"])
def test_cuda_adjoint_gradients_match_cpu(cuda, kind):
    """Each adjoint class on the card (the kernels in every forward and
    adjoint matvec) against the CPU at 17^3 f64: values within 1e-10 and
    gradients within 1e-9 relative."""
    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil as ax
    from pyapes_tpu_torch.ops.diff_field import diff_field as df

    v_cpu, g_cpu = _value_and_grad(*_adjoint_case(kind, torch.device("cpu")))
    before = ax.launches + df.launches
    v_gpu, g_gpu = _value_and_grad(*_adjoint_case(kind, cuda))
    assert ax.launches + df.launches > before
    assert float((v_gpu - v_cpu).abs().max()) <= 1e-10 * float(v_cpu.abs().max())
    assert float((g_gpu - g_cpu).abs().max()) <= 1e-9 * float(g_cpu.abs().max())


@pytest.mark.parametrize("shape", [(1, 17, 9, 11), (2, 33, 16, 130), (1, 128, 128, 128),
                                   (1, 65, 130)])
@pytest.mark.parametrize("aniso,avg", [(False, "arithmetic"), (True, "harmonic")])
def test_cuda_diff_field_transpose_matches_plain(cuda, shape, aniso, avg):
    """The hand transpose through the variable-Γ kernel (the march at
    128^3, the per-point kernel below it and on a 2-D grid) equals its
    plain form on the same inputs (f64, 1e-12), with Neumann faces on
    every axis; so does the Γ-gradient."""
    from pyapes_tpu_torch.ops.diff_field import diff_field as df
    from pyapes_tpu_torch.solver.adjoint import diff_field_gamma_vjp, diff_field_transpose

    nd = len(shape) - 1
    nx = shape[1:]
    g = torch.Generator(device="cpu").manual_seed(3)
    gamma = 1.0 + torch.rand((nd, *nx) if aniso else nx, generator=g, dtype=torch.float64)
    y = torch.randn(shape, generator=g, dtype=torch.float64)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    inv = tuple(float(n - 1) ** 2 for n in nx)
    surgery = (("neumann", "none"), ("none", "neumann"), ("neumann", "neumann"))[:nd]
    ref = diff_field_transpose(y, gamma, inv, surgery, avg)
    before = df.launches
    got = diff_field_transpose(y.to(cuda), gamma.to(cuda), inv, surgery, avg).cpu()
    assert df.launches == before + 1
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    gv = diff_field_gamma_vjp(y.to(cuda), x.to(cuda), gamma.to(cuda), inv, surgery, avg).cpu()
    gr = diff_field_gamma_vjp(y, x, gamma, inv, surgery, avg)
    assert float((gv - gr).abs().max()) <= 1e-12 * float(gr.abs().max())


def _cavity17(device):
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import LidDrivenCavity

    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [17] * 3, device=device, dtype="double")
    return LidDrivenCavity(mesh, nu=0.01, lid_profile="regularized"), 0.25 / 16


@pytest.mark.parametrize("donate", [False, True])
def test_cuda_fused_runner_steps_from_loaded_state(cuda, donate, tmp_path):
    """A fused runner that captured before a ``load`` steps from the loaded
    state: the 3 replays after the load repeat the 3 replays after the
    save bit for bit, with the same itr."""
    from pyapes_tpu_torch.utils import checkpoint

    model, dt = _cavity17(cuda)
    if donate:
        model.fused_runner(donate=True)
    model.run(dt, 2, fused=True)
    runner = model.fused_runner()
    fields = model.vel + [model.p]
    checkpoint.save(str(tmp_path / "ck"), fields)
    t_saved = model.t
    runner.run(dt, 3)
    first = [f().clone() for f in model.state_fields()]
    itr_first = [int(r["itr"]) for r in runner.reports]
    runner.run(dt, 2)  # move on, then go back
    checkpoint.load(str(tmp_path / "ck"), fields)
    model.t = t_saved
    runner.run(dt, 3)
    assert runner.captures == 1
    assert [int(r["itr"]) for r in runner.reports] == itr_first
    for a, f in zip(first, model.state_fields()):
        assert torch.equal(a, f()), f.name


def test_cuda_async_save_snapshot_ignores_later_writes(cuda, tmp_path):
    """``save_orbax(block=False)`` snapshots the device state at the call:
    in-place writes on the current stream right after it never reach the
    file."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.utils import checkpoint
    from pyapes_tpu_torch.variables import Field

    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [256] * 3, device=cuda, dtype="single")
    f = Field("u", 1, mesh, None, init_val="random")
    f.set_time(0.1, 0.7)
    snap = f().clone()
    checkpoint.save_orbax(str(tmp_path / "ck"), [f], block=False)
    for _ in range(20):
        f().mul_(-3.0).add_(1.0)  # in place, queued behind the snapshot
    checkpoint.wait_for_checkpoints()
    g = Field("u", 1, mesh, None, init_val=0.0)
    checkpoint.load_orbax(str(tmp_path / "ck"), [g])
    assert g().device.type == "cuda" and torch.equal(g(), snap) and g._t == 0.7


# -- the solver options and utilities ported last ------------------------------
class _F32Poisson:
    """A 3-D f32 homogeneous-Dirichlet Poisson problem on the card with a
    seeded RHS: ``solve(cfg, x0=None)`` returns (solution, report)."""

    def __init__(self, device, n: int = 65, gamma=False):
        from pyapes_tpu_torch.geometry import Box
        from pyapes_tpu_torch.mesh import Mesh
        from pyapes_tpu_torch.variables import Field
        from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

        mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device=device, dtype="single")
        self.var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet")})
        self.rhs = torch.as_tensor(np.random.default_rng(11).standard_normal((1, n, n, n)),
                                   dtype=torch.float32, device=device)
        self.coeff = 1.0
        if gamma:
            self.coeff = torch.exp(0.5 * torch.sin(6.0 * mesh.X) * torch.cos(5.0 * mesh.Y)
                                   * torch.sin(4.0 * mesh.Z)).contiguous()

    def solve(self, cfg, x0=None, rhs=None, coeff=None):
        from pyapes_tpu_torch.solver.fdm import FDM
        from pyapes_tpu_torch.solver.ops import Solver

        self.var.VAR = torch.zeros_like(self.var()) if x0 is None else x0
        s = Solver({"fdm": cfg})
        s.set_eq(FDM().laplacian(self.coeff if coeff is None else coeff, self.var)
                 == (self.rhs if rhs is None else rhs))
        rep = s.solve()
        return self.var(), rep


def _precision_flags():
    m = torch.backends.cuda.matmul
    return (m.allow_tf32, torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision(),
            m.allow_bf16_reduced_precision_reduction)


FD_CFG = {"method": "fastdiag", "tol": 1e-6, "max_it": 100, "criterion": "residual"}


# 130^3 nodes: a 128^3 active set, whose GEMMs cuBLAS runs on the tensor
# cores in TF32 (at 65^3 it keeps its FFMA kernels: "default" = "highest")
N_TF32 = 130


def test_cuda_fd_opts_tf32_scoped_and_converging(cuda, monkeypatch):
    """``precision: "default"`` runs the transforms in TF32 (other bits than
    "highest"), bf16 factors too; the direct solve takes more passes and may
    stop at the narrow transform's floor (the stall exit), so each also
    preconditions CG, which meets the tolerance; every flag is back
    afterwards, also when a transform raises."""
    from pyapes_tpu_torch.solver import fastdiag as fd_mod

    prob = _F32Poisson(cuda, n=N_TF32)
    flags = _precision_flags()
    assert not flags[0] and not flags[1] and flags[2] == "highest"
    sols = {}
    for label, opts in (("highest", None), ("default", {"precision": "default"}),
                        ("bf16", {"dtype": "bfloat16"})):
        cfg = {"fd_opts": opts} if opts else {}
        x, rep = prob.solve({**FD_CFG, **cfg})
        assert rep["itr"] >= 1 and np.isfinite(rep["tol"]), (label, rep)
        assert rep["converge"] or label != "highest", rep
        sols[label] = x.clone()
        _, krep = prob.solve({"method": "cg", "precond": "fd", "tol": 1e-6, "max_it": 100,
                              "criterion": "residual", **cfg})
        assert krep["converge"] and krep["tol"] <= 1e-6, (label, krep)
        assert _precision_flags() == flags
    assert not torch.equal(sols["default"], sols["highest"])

    def boom(self, a, b):
        assert torch.backends.cuda.matmul.allow_tf32
        raise KeyError("inside a transform")

    monkeypatch.setattr(fd_mod.FastDiag, "_mm", boom)
    with pytest.raises(KeyError):
        prob.solve({**FD_CFG, "fd_opts": {"precision": "default"}})
    assert _precision_flags() == flags


def test_cuda_fd_default_tf32_in_a_captured_replay(cuda):
    """cuBLAS fixes its math mode at capture: a ``sync: False`` fastdiag
    solve with ``precision: "default"`` replays the eager TF32 solve's bits
    (not "highest"'s), and the flags stay off around the replay."""
    prob = _F32Poisson(cuda, n=N_TF32)
    flags = _precision_flags()
    cfg = {**FD_CFG, "fd_opts": {"precision": "default"}}
    x_eager, rep = prob.solve(cfg)
    x_eager = x_eager.clone()
    x_hi, _ = prob.solve(FD_CFG)
    x_hi = x_hi.clone()
    for _ in range(3):  # the warm-up and capture, then replays
        x, r = prob.solve({**cfg, "sync": False})
        assert torch.equal(x, x_eager) and int(r["itr"]) == rep["itr"]
        assert _precision_flags() == flags
    assert not torch.equal(x_eager, x_hi)


def test_cuda_debug_names_the_hand_kernel(cuda):
    """A NaN first produced by a hand kernel is named by its wrapper: the
    axis stencil on a NaN input, and a variable-Γ MG-PCG solve with a NaN
    in Γ (``diff_field`` / ``diff_jacobi``, before the end-of-solve check);
    a NaN in the RHS names an operator."""
    from pyapes_tpu_torch.utils.debug import NaNError, nan_check

    x = torch.ones((1, 33, 34, 35), device=cuda)
    x[0, 3, 4, 5] = float("nan")
    coeffs = tuple(tuple(torch.full((n,), 0.5, device=cuda) for _ in range(3))
                   for n in x.shape[1:])
    with pytest.raises(NaNError) as info:
        with nan_check():
            axis_stencil(coeffs, x)
    assert info.value.op == "axis_stencil"
    prob = _F32Poisson(cuda, n=129, gamma=True)
    cfg = {"method": "cg", "precond": "mg", "tol": 1e-6, "max_it": 100, "criterion": "residual",
           "debug": "nan", "mg_opts": {"dtype": "bfloat16", "fmg": True}}
    g = prob.coeff.clone()
    g[60, 50, 40] = float("nan")
    with pytest.raises(NaNError) as info:
        prob.solve(cfg, coeff=g)
    assert info.value.op in ("diff_field", "diff_jacobi")
    b = prob.rhs.clone()
    b[0, 60, 50, 40] = float("nan")
    with pytest.raises(NaNError, match="aten"):
        prob.solve(cfg, rhs=b)


@pytest.mark.parametrize("method", ["fastdiag", "mgpcg", "darcy"])
def test_cuda_debug_clean_solve_same_bits(cuda, method):
    """A clean checked solve gives the unchecked bits and itr on the card,
    the hand kernels checked."""
    prob = _F32Poisson(cuda, n=129, gamma=method == "darcy")
    cfg = dict(FD_CFG) if method == "fastdiag" else {
        "method": "cg", "precond": "mg", "tol": 1e-6, "max_it": 100, "criterion": "residual",
        "mg_opts": {"dtype": "bfloat16", "fmg": True}}
    x, rep = prob.solve(cfg)
    x = x.clone()
    xc, repc = prob.solve({**cfg, "debug": "nan"})
    assert torch.equal(x, xc) and rep == repc


def test_cuda_donate_lowers_the_peak(cuda):
    """``donate: True`` solves in the guess's storage: the same bits, and
    ``max_memory_allocated`` above the live tensors lower by about one grid
    (at least 0.9 of it)."""
    prob = _F32Poisson(cuda, n=256)
    grid = 256**3 * 4
    prob.solve(FD_CFG)  # the factors
    above, sols = {}, {}
    for donate in (False, True):
        x0 = torch.zeros_like(prob.var())
        prob.var.VAR = x0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        x, _ = prob.solve({**FD_CFG, "donate": donate}, x0=x0)
        torch.cuda.synchronize()
        above[donate] = torch.cuda.max_memory_allocated() - base
        assert (x.data_ptr() == x0.data_ptr()) is donate
        sols[donate] = x
        del x0, x
    assert torch.equal(sols[False], sols[True])
    assert above[False] - above[True] >= 0.9 * grid, above


def test_cuda_kernel_pallas_equals_auto(cuda):
    """``kernel: "pallas"`` is "auto"'s path on the card: the same bits and
    the same launches of every wrapper; "jnp" raises."""
    fns = [axis_stencil, axis_stencil_dot, jacobi3d, jacobi3d_dot, jacobi3d_x2]
    prob = _F32Poisson(cuda, n=129)
    cfg = {"method": "cg", "precond": "mg", "tol": 1e-6, "max_it": 100, "criterion": "residual",
           "mg_opts": {"dtype": "bfloat16", "fmg": True, "fuse_rz": True, "n_post": 1}}
    got = {}
    for kernel in ("auto", "pallas"):
        before = [f.launches for f in fns]
        x, rep = prob.solve({**cfg, "kernel": kernel})
        got[kernel] = (x.clone(), rep, [f.launches - b for f, b in zip(fns, before)])
    assert torch.equal(got["auto"][0], got["pallas"][0])
    assert got["auto"][1:] == got["pallas"][1:] and sum(got["auto"][2]) > 0
    with pytest.raises(NotImplementedError):
        prob.solve({**cfg, "kernel": "jnp"})


# -- placed decompositions: blocks on their own devices --------------------


def _placed_solve(dev, nx, cfg, decomp=None, seed=0):
    """``-lap x = b`` in f64 on the unit box ``nx`` (homogeneous Dirichlet,
    seeded random RHS) with the Field on ``dev``: the solution on the CPU,
    the report."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    mesh = Mesh(Box[(slice(0, 1),) * len(nx)], None, list(nx), device=str(dev), dtype="double")
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(len(nx), 0.0, "dirichlet"),
                               "obstacle": None}, init_val=0.0)
    rhs = torch.from_numpy(np.random.default_rng(seed).standard_normal((1, *nx))).to(dev)
    if decomp is not None:
        cfg = {**cfg, "decomp": decomp}
    s = Solver({"fdm": {"report": False, **cfg}})
    s.set_eq(FDM().laplacian(1.0, var) == rhs)
    rep = s.solve()
    return var()[0].cpu(), rep


# tol 1e-8 in f64, well above the attainable accuracy
PLACED_CFGS = {
    "cg": {"method": "cg", "tol": 1e-8, "max_it": 800, "criterion": "residual"},
    "bicgstab": {"method": "bicgstab", "tol": 1e-8, "max_it": 800, "criterion": "residual"},
    "mg": {"method": "cg", "tol": 1e-8, "max_it": 200, "criterion": "residual",
           "precond": "mg"},
    "mg_bicgstab": {"method": "bicgstab", "tol": 1e-8, "max_it": 200, "criterion": "residual",
                    "precond": "mg"},
    "fastdiag": {"method": "fastdiag", "tol": 1e-8, "max_it": 50, "criterion": "residual"},
    "cg_fd": {"method": "cg", "tol": 1e-8, "max_it": 200, "criterion": "residual",
              "precond": "fd"},
    "bicgstab_fd": {"method": "bicgstab", "tol": 1e-8, "max_it": 200, "criterion": "residual",
                    "precond": "fd"},
}
# (|d itr|, atol) against the view-based solve. Unpreconditioned BiCGSTAB
# on this SPD problem converges erratically: RHS perturbations of 1e-15
# relative move its count between 108 and 118 on the CPU (view-based 111),
# and so does the dots' summation order (per-block partials, then block
# order): placed 118 on the CPU, 121 against 113 on the card. Its solution
# is held at the tolerance's scale (CPU: 5.1e-10 apart, max|x| 1.4e-3).
PLACED_GATES = {"bicgstab": (12, 1e-8)}


@pytest.mark.parametrize("method", sorted(PLACED_CFGS))
def test_cuda_placed_on_one_card_equals_the_view_based_solve(cuda, method):
    """Eight blocks placed on cuda:0, each its own allocation: the view-based
    decomposition's itr and solution (1e-12; unpreconditioned BiCGSTAB:
    ``PLACED_GATES``), one halo-extended launch per block and placed apply,
    no gather in CG, BiCGSTAB or fastdiag; the FD paths move whole vectors
    between pencils, every byte within the one card."""
    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks, halo

    nx = (32, 32, 64)
    ref, rref = _placed_solve(cuda, nx, PLACED_CFGS[method], DomainDecomposition((4, 2, 1)))
    e0, a0, g0 = axis_stencil_ext.launches, halo.placed_applies, blocks.gathers
    r0, w0, x0 = (blocks.repartitions, blocks.repartition_bytes_within,
                  blocks.repartition_bytes_across)
    out, rep = _placed_solve(cuda, nx, PLACED_CFGS[method],
                             DomainDecomposition((4, 2, 1), devices=("cuda:0",) * 8))
    torch.cuda.synchronize()
    applies = halo.placed_applies - a0
    slack, atol = PLACED_GATES.get(method, (0, 1e-12))
    assert rep["converge"] and abs(rep["itr"] - rref["itr"]) <= slack, (rep, rref)
    assert applies > rep["itr"] and axis_stencil_ext.launches - e0 == 8 * applies
    if not method.startswith("mg"):
        assert blocks.gathers == g0
    moves = blocks.repartitions - r0
    assert (moves > 0) == (method in ("fastdiag", "cg_fd", "bicgstab_fd"))
    assert blocks.repartition_bytes_within - w0 == moves * int(np.prod(nx)) * 8
    assert blocks.repartition_bytes_across == x0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("case", ["cg3d", "mg3d", "cg2d", "fd3d", "fd2d"])
def test_cuda_mixed_card_and_cpu_placement(cuda, case):
    """Blocks alternating between cuda:0 and the CPU (the Field on cuda:0):
    every operation of a block takes its own device's operands, the card
    blocks launch the kernels and the CPU blocks run the plain versions
    (the fastdiag repartitions copy between the card and the CPU); the
    view-based solve's itr and solution (1e-10)."""
    from pyapes_tpu_torch.parallel import DomainDecomposition

    nx, ms, cfg = {"cg3d": ((32, 32, 32), (2, 2, 2), PLACED_CFGS["cg"]),
                   "mg3d": ((32, 32, 32), (2, 2, 2), PLACED_CFGS["mg"]),
                   "cg2d": ((64, 64), (4, 1), PLACED_CFGS["cg"]),
                   "fd3d": ((32, 32, 32), (2, 2, 2), PLACED_CFGS["fastdiag"]),
                   "fd2d": ((64, 64), (4, 1), PLACED_CFGS["fastdiag"])}[case]
    devs = ("cuda:0", "cpu") * (int(np.prod(ms)) // 2)
    ref, rref = _placed_solve(cuda, nx, cfg, DomainDecomposition(ms), seed=1)
    e0, s0 = axis_stencil_ext.launches, axis_stencil.launches
    out, rep = _placed_solve(cuda, nx, cfg, DomainDecomposition(ms, devices=devs), seed=1)
    assert rep["converge"] and rep["itr"] == rref["itr"], (rep, rref)
    assert (axis_stencil_ext.launches - e0 if len(nx) == 3 else axis_stencil.launches - s0) > 0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-10, rtol=0)


@pytest.mark.parametrize("method", ["cg", "mg", "fastdiag", "cg_fd"])
def test_cuda_placed_across_two_cards(cuda, method):
    """Blocks round robin over cuda:0 and cuda:1 (peer copies of the ghost
    faces and, on the FD paths, of the pencil repartitions' slices;
    partials moved to the lead card): the view-based solve on cuda:0 (the
    same itr, 1e-12)."""
    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards; this machine shows {n}")
    nx = (32, 32, 64)
    ref, rref = _placed_solve(cuda, nx, PLACED_CFGS[method], DomainDecomposition((4, 2, 1)))
    x0 = blocks.repartition_bytes_across
    out, rep = _placed_solve(cuda, nx, PLACED_CFGS[method],
                             DomainDecomposition((4, 2, 1), devices=("cuda:0", "cuda:1") * 4))
    assert rep["converge"] and rep["itr"] == rref["itr"], (rep, rref)
    assert (blocks.repartition_bytes_across > x0) == (method in ("fastdiag", "cg_fd"))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-12, rtol=0)


# -- Fields whose value stays on its blocks ----------------------------------


def _block_field_solve(dev, nx, cfg, devices, gamma=False, seed=0):
    """``_placed_solve``'s problem (``gamma``: the variable-Γ Laplacian of Γ
    = 1 + x) with the Field, the RHS and Γ block vectors of ``(4, 2, 1)`` on
    ``devices`` (``blocks.put`` from the host: no whole tensor on a card):
    the solution gathered on the host, the report, and the counters' deltas
    (gathers, V-cycles and their gathers, Γ's hand-over)."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks
    from pyapes_tpu_torch.solver import FDM, Solver, multigrid
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    dd = DomainDecomposition((4, 2, 1), devices=devices)
    mesh = Mesh(Box[(slice(0, 1),) * len(nx)], None, list(nx), device=str(dev), dtype="double")
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(len(nx), 0.0, "dirichlet"),
                               "obstacle": None},
                init_val=blocks.put(torch.zeros((1, *nx), dtype=torch.float64), dd))
    rhs = blocks.put(torch.from_numpy(np.random.default_rng(seed).standard_normal((1, *nx))), dd)
    coeff = 1.0
    if gamma:
        x = np.linspace(0, 1, nx[0]).reshape(-1, 1, 1)
        coeff = blocks.put(torch.from_numpy(1.0 + x + np.zeros(nx))[None], dd)
    keys = lambda: (blocks.gathers, multigrid.vcycles, multigrid.cycle_gathers,  # noqa: E731
                    multigrid.fmg_gathers, multigrid.gamma_gathers)
    c0 = keys()
    s = Solver({"fdm": {"report": False, **cfg}})
    s.set_eq(FDM().laplacian(coeff, var) == rhs)
    rep = s.solve()
    assert isinstance(var(), blocks.BlockTensor)
    assert var().placement is blocks.layout(dd, nx, devices[0])
    return var().cpu()[0], rep, [a - b for a, b in zip(keys(), c0)]


def _view_reference(dev, nx, cfg, gamma=False, seed=0):
    """The same problem with a whole Field on ``dev``, view-based (4, 2, 1)."""
    from pyapes_tpu_torch.parallel import DomainDecomposition

    if not gamma:
        return _placed_solve(dev, nx, cfg, DomainDecomposition((4, 2, 1)), seed)
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    mesh = Mesh(Box[(slice(0, 1),) * len(nx)], None, list(nx), device=str(dev), dtype="double")
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet"), "obstacle": None},
                init_val=0.0)
    rhs = torch.from_numpy(np.random.default_rng(seed).standard_normal((1, *nx))).to(dev)
    x = np.linspace(0, 1, nx[0]).reshape(-1, 1, 1)
    g = torch.from_numpy(1.0 + x + np.zeros(nx)).to(dev)
    s = Solver({"fdm": {"report": False, **cfg, "decomp": DomainDecomposition((4, 2, 1))}})
    s.set_eq(FDM().laplacian(g, var) == rhs)
    rep = s.solve()
    return var()[0].cpu(), rep


BLOCK_FIELD_CFGS = {k: PLACED_CFGS[k] for k in ("cg", "mg", "fastdiag", "cg_fd")}
BLOCK_FIELD_CFGS["darcy"] = PLACED_CFGS["mg"]


@pytest.mark.parametrize("placement", ["one_card", "mixed", "two_cards"])
@pytest.mark.parametrize("method", sorted(BLOCK_FIELD_CFGS))
def test_cuda_block_field_solves(cuda, method, placement):
    """A Field whose value stays on ``(4, 2, 1)`` blocks (the RHS and, for
    Darcy, Γ too) on ``("cuda:0",) * 8``, on card and CPU blocks in turn, or
    round robin over two cards (skips on one): the view-based solve's
    ``itr`` and solution (1e-12), the solution still on the blocks; the
    V-cycle gathers only at its hand-over (Γ's once), CG and fastdiag
    nothing."""
    devices = {"one_card": ("cuda:0",) * 8, "mixed": ("cuda:0", "cpu") * 4,
               "two_cards": ("cuda:0", "cuda:1") * 4}[placement]
    if placement == "two_cards" and torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards; this machine shows {torch.cuda.device_count()}")
    nx = (32, 32, 64)
    cfg, darcy = BLOCK_FIELD_CFGS[method], method == "darcy"
    ref, rref = _view_reference(cuda, nx, cfg, darcy)
    out, rep, (gathers, cycles, in_cycles, fmg, gam) = _block_field_solve(cuda, nx, cfg, devices,
                                                                           darcy)
    assert rep["converge"] and rep["itr"] == rref["itr"], (rep, rref)
    assert in_cycles == cycles and gam == int(darcy)
    assert gathers == in_cycles + fmg + gam
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-12, rtol=0)


# -- placed variable-Γ and Div/Conv terms, placed PeriodicFlow --------------


def _placed_term_apply(kind, devices, dtype, seed=0):
    """One placed apply of ``kind`` ("diff_field", "diff_jacobi_<mode>",
    "advect_pair_<limiter>_<form>", "conv_component_<limiter>") on (4, 2, 1)
    blocks of a 32 x 48 x 160 grid on ``devices``, from seeded operands:
    the gathered output on the CPU."""
    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks, halo

    nx = (32, 48, 160)
    rng = np.random.default_rng(seed)
    dd = DomainDecomposition((4, 2, 1), devices=devices)
    lay = blocks.layout(dd, nx, torch.device(devices[0]))

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)

    x, b = blocks.scatter(arr(2, *nx), lay), blocks.scatter(arr(2, *nx), lay)
    surgery = (("neumann", "none"), ("none", "neumann"), ("none", "none"))
    if kind.startswith("diff"):
        g = blocks.scatter_operand((0.5 + torch.from_numpy(rng.random((3, *nx)))).to(dtype), lay)
        inv = [float(n - 1) ** 2 for n in nx]
        if kind == "diff_field":
            out = halo.placed_diff_field(x, g, inv, surgery, "harmonic", (), {})
        else:
            mode = kind.split("_")[-1]
            out = halo.placed_diff_jacobi(None if mode == "smooth0" else x, b, g, inv, surgery,
                                          "arithmetic", 0.8, (0, 1, 2), mode, {})
    else:
        from pyapes_tpu_torch.geometry import Box
        from pyapes_tpu_torch.mesh import Mesh
        from pyapes_tpu_torch.ops.stencil import div_axis_coeffs

        parts = kind.split("_")
        mesh = Mesh(Box[0:1, 0:1, 0:1], None, list(nx), device="cpu", dtype="double")
        base = tuple(tuple(torch.as_tensor(c).to(dtype).to(devices[0]) for c in cs)
                     for cs in div_axis_coeffs(mesh, None, 1.0, "none"))
        conv = parts[0] == "conv"
        form = "advective" if conv else parts[3]
        fn = halo.make_sharded_advect_apply(dd, "conv" if conv else "div", 3, parts[2], surgery,
                                            form)
        out = fn(blocks.scatter(arr(3, *nx), lay), blocks.scatter_operand(arr(3, *nx), lay), base)
    return blocks.gather(out, count=False).cpu()


PLACED_TERM_KINDS = ["diff_field", "diff_jacobi_smooth", "diff_jacobi_smooth0",
                     "diff_jacobi_resid", "advect_pair_none_conservative",
                     "advect_pair_none_advective", "advect_pair_upwind_conservative",
                     "conv_component_none", "conv_component_upwind"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", PLACED_TERM_KINDS)
def test_cuda_placed_term_kernels_equal_their_plain_versions(cuda, kind, dtype):
    """Each of the four kernels on eight card blocks (``("cuda:0",) * 8``):
    one launch per block and apply, the output equal to the same apply on
    CPU blocks (the plain versions) within ``TOL`` of its largest value."""
    from pyapes_tpu_torch.ops.advect import advect_pair as ap, conv_component as cc
    from pyapes_tpu_torch.ops.diff_field import diff_field as dfn, diff_jacobi as djn

    wrapper = {"diff_field": dfn, "diff_jacobi": djn, "advect_pair": ap,
               "conv_component": cc}[next(k for k in ("diff_field", "diff_jacobi",
                                                      "advect_pair", "conv_component")
                                          if kind.startswith(k))]
    l0 = wrapper.launches
    got = _placed_term_apply(kind, ("cuda:0",) * 8, dtype)
    torch.cuda.synchronize()
    assert wrapper.launches - l0 == 8
    want = _placed_term_apply(kind, ("cpu",) * 8, dtype)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= TOL[dtype] * scale


def _placed_model_run(kind, dev, decomp):
    """f64 runs of the placed slice's models on ``dev`` with ``decomp``:
    "darcy" (a 32^3 variable-Γ CG + Γ-aware MG solve), "burgers" (2
    ``BurgersND`` steps, 17^3, the torus 16^3), "tgv" (3 steps of the
    Smagorinsky TGV-3D LES, 17^3): ``(itr per solve, fields on the CPU)``."""
    from math import pi

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import BurgersND, PeriodicFlow, smagorinsky_viscosity
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    if kind == "darcy":
        n = 32
        mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device=str(dev), dtype="double")
        var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet"),
                                   "obstacle": None}, init_val=0.0)
        g = torch.exp(0.8 * torch.sin(2 * pi * mesh.X) * torch.sin(2 * pi * mesh.Y)
                      * torch.sin(2 * pi * mesh.Z)).contiguous()
        rhs = torch.from_numpy(np.random.default_rng(2).standard_normal((1, n, n, n))).to(dev)
        s = Solver({"fdm": {"method": "cg", "precond": "mg", "tol": 1e-8, "max_it": 200,
                            "criterion": "residual", "report": False, "decomp": decomp}})
        s.set_eq(FDM().laplacian(g, var) == rhs)
        return [s.solve()["itr"]], [var().cpu()]
    L = 2 * pi
    mesh = Mesh(Box[0:L, 0:L, 0:L], None, [17] * 3, device=str(dev), dtype="double")
    X, Y, Z = mesh.X, mesh.Y, mesh.Z
    u0 = torch.sin(X) * torch.cos(Y) * torch.cos(Z)
    v0 = -torch.cos(X) * torch.sin(Y) * torch.cos(Z)
    itr = []
    if kind == "burgers":
        model = BurgersND(mesh, nu=0.1, init_vals=[u0[None], v0[None], torch.zeros_like(u0)[None]],
                          config={"decomp": decomp})
        solvers, fields = [model.solver], model.vel
    else:
        model = PeriodicFlow(mesh, nu=1 / 1600, config={"decomp": decomp},
                             mu_strain_fn=smagorinsky_viscosity(1 / 1600, mesh, cs=0.17))
        model.set_velocity(u0, v0, torch.zeros_like(u0))
        solvers, fields = [model.mom_solver, model.p_solver], model.state_fields()
    for solver in solvers:
        real = solver.solve

        def solve(real=real):
            rep = real()
            itr.append(rep["itr"])
            return rep

        solver.solve = solve
    if kind == "burgers":
        model.run(0.01, 2)
    else:
        model.run(0.2 * L / 16, 3)
    return itr, [f().cpu() for f in fields]


@pytest.mark.parametrize("kind", ["darcy", "burgers", "tgv"])
def test_cuda_mixed_placed_terms(cuda, kind):
    """(4, 2, 1) blocks alternating between cuda:0 and the CPU: the
    variable-Γ CG with the Γ-aware MG, ``BurgersND`` (the placed Conv) and
    the Smagorinsky LES (the placed variable-Γ momentum, the placed
    fastdiag pressure) take the view-based runs' itr on the card, solve by
    solve, and their fields (1e-10 of each field's largest value)."""
    from pyapes_tpu_torch.parallel import DomainDecomposition

    ref_itr, ref = _placed_model_run(kind, cuda, DomainDecomposition((4, 2, 1)))
    itr, out = _placed_model_run(kind, cuda, DomainDecomposition((4, 2, 1),
                                                                  devices=("cuda:0", "cpu") * 4))
    assert itr == ref_itr
    for a, b in zip(out, ref):
        assert (a - b).abs().max().item() <= 1e-10 * b.abs().max().clamp_min(1e-30).item()


@pytest.mark.parametrize("kind", ["darcy", "burgers", "tgv"])
def test_cuda_placed_terms_across_two_cards(cuda, kind):
    """The same runs with the blocks round robin over cuda:0 and cuda:1
    (peer copies of the ghost faces and Γ's and the advector's faces): the
    view-based runs' itr and fields (1e-12 relative)."""
    from pyapes_tpu_torch.parallel import DomainDecomposition

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards; this machine shows {n}")
    ref_itr, ref = _placed_model_run(kind, cuda, DomainDecomposition((4, 2, 1)))
    itr, out = _placed_model_run(kind, cuda, DomainDecomposition(
        (4, 2, 1), devices=("cuda:0", "cuda:1") * 4))
    assert itr == ref_itr
    for a, b in zip(out, ref):
        assert (a - b).abs().max().item() <= 1e-12 * b.abs().max().clamp_min(1e-30).item()


# -- placed sync: False solves and fused steps: graphs on one card ---------


def _placed_graph_problem(dev, kind, field, devices=("cuda:0",) * 8, nx=(32, 32, 64)):
    """``_block_field_solve``'s problem on ``(4, 2, 1)`` blocks on
    ``devices``: fastdiag, CG + MG, or Darcy (the variable-Γ Laplacian of Γ
    = 1 + x, CG + the Γ-aware MG); ``field`` "blocks": the Field, the RHS
    and Γ block vectors, "whole": tensors on ``dev``. Returns ``solve(sync)
    -> (the solution's blocks, or the whole solution, cloned; the report)``,
    each call from zeros through a new ``Solver``."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    dd = DomainDecomposition((4, 2, 1), devices=devices)

    def put(t):
        return blocks.put(t, dd) if field == "blocks" else t.to(dev)

    mesh = Mesh(Box[(slice(0, 1),) * 3], None, list(nx), device=str(dev), dtype="double")
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet"),
                               "obstacle": None}, init_val=0.0)
    rhs = put(torch.from_numpy(np.random.default_rng(0).standard_normal((1, *nx))))
    zeros = put(torch.zeros((1, *nx), dtype=torch.float64))
    coeff = 1.0
    if kind == "darcy":
        g = torch.from_numpy(1.0 + np.linspace(0, 1, nx[0]).reshape(-1, 1, 1) + np.zeros(nx))
        coeff = put(g[None]) if field == "blocks" else g.to(dev)
    cfg = {**BLOCK_FIELD_CFGS[kind], "decomp": dd, "report": False}

    def solve(sync):
        var.VAR = zeros.clone()
        s = Solver({"fdm": {**cfg, "sync": sync}})
        s.set_eq(FDM().laplacian(coeff, var) == rhs)
        rep = s.solve()
        x = var()
        return [p.clone() for p in x.parts] if isinstance(x, blocks.BlockTensor) else [
            x.clone()], rep

    return solve


@pytest.mark.parametrize("field", ["blocks", "whole"])
@pytest.mark.parametrize("kind", ["fastdiag", "mg", "darcy"])
def test_cuda_placed_sync_false_replays_equal_eager(cuda, kind, field):
    """A ``sync: False`` solve on eight blocks on cuda:0 (a Field on the
    blocks, or a whole Field scattered and gathered inside the graph) is one
    graph of the solve, captured at the first call: 20 replays in a row each
    give the ``sync: True`` solve's bits and ``itr`` (a 0-d tensor), make no
    host sync (``set_sync_debug_mode("error")``) and read no block vector on
    the host."""
    from pyapes_tpu_torch.ops import graph_loop
    from pyapes_tpu_torch.parallel import blocks

    solve = _placed_graph_problem(cuda, kind, field)
    ref, rref = solve(True)
    solve(False)  # the warm-up and the capture
    nodes, h0 = graph_loop.nodes, blocks.host_gathers
    for _ in range(20):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, rep = solve(False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert isinstance(rep["itr"], torch.Tensor) and rep["itr"].dim() == 0
        assert int(rep["itr"]) == rref["itr"]
        assert len(out) == len(ref) and all(torch.equal(a, b) for a, b in zip(out, ref))
    assert graph_loop.nodes == nodes  # replays, not captures
    assert blocks.host_gathers == h0


def _fused_placed_models(dev, devices, n=33):
    """Two Smagorinsky TGV-3D LES models (f64, ``n``^3 nodes, the torus
    ``(n - 1)``^3) whose solves run on ``(4, 2, 1)`` blocks on ``devices``,
    and ``dt``."""
    from math import pi

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import PeriodicFlow
    from pyapes_tpu_torch.models.navier_stokes import smagorinsky_viscosity
    from pyapes_tpu_torch.parallel import DomainDecomposition

    dd = DomainDecomposition((4, 2, 1), devices=devices)

    def make():
        mesh = Mesh(Box[0:2 * pi, 0:2 * pi, 0:2 * pi], None, [n] * 3, device=dev,
                    dtype="double")
        m = PeriodicFlow(mesh, nu=1 / 1600, config={"decomp": dd},
                         mu_strain_fn=smagorinsky_viscosity(1 / 1600, mesh))
        X, Y, Z = mesh.grid
        m.set_velocity(torch.sin(X) * torch.cos(Y) * torch.cos(Z),
                       -torch.cos(X) * torch.sin(Y) * torch.cos(Z), torch.zeros_like(X))
        return m

    return make(), make(), 0.2 * 2 * pi / (n - 1)


def test_cuda_fused_placed_periodic_flow_equals_eager(cuda):
    """The fused runner over a ``PeriodicFlow`` LES whose momentum and
    pressure solves run on eight blocks on cuda:0: one capture, no fallback
    (the warning is an error here), replays without a host sync, the eager
    placed steps' ``itr`` solve by solve and their bits."""
    import warnings

    from pyapes_tpu_torch.solver.ops import solve_log

    m1, m2, dt = _fused_placed_models(cuda, ("cuda:0",) * 8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m1.run(dt, 2)
        m2.run(dt, 2, fused=True)
        runner = m2.fused_runner()
        for _ in range(3):
            with solve_log() as log:
                m1.step(dt)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                runner.step(dt)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert [int(r["itr"]) for r in runner.reports] == [int(r["itr"]) for r in log]
    assert runner.captures == 1
    for a, b in zip(m1.state_fields(), m2.state_fields()):
        assert torch.equal(a(), b()), a.name


def test_cuda_placed_graphs_on_card_and_cpu_blocks(cuda):
    """Blocks alternating between cuda:0 and the CPU: a ``sync: False``
    solve runs the host loop (a host block's work cannot join a graph) and
    gives the ``sync: True`` bits and ``itr``; a fused step raises
    ``NotImplementedError`` naming A11f, never a fallback to eager steps."""
    from pyapes_tpu_torch.ops import graph_loop

    devs = ("cuda:0", "cpu") * 4
    solve = _placed_graph_problem(cuda, "mg", "whole", devs)
    ref, rref = solve(True)
    nodes = graph_loop.nodes
    for _ in range(2):
        out, rep = solve(False)
        assert int(rep["itr"]) == rref["itr"] and torch.equal(out[0], ref[0])
    assert graph_loop.nodes == nodes
    _, m2, dt = _fused_placed_models(cuda, devs, n=17)
    with pytest.raises(NotImplementedError, match="A11f"):
        m2.run(dt, 2, fused=True)


@pytest.mark.parametrize("kind", ["cg", "mg", "fastdiag", "cg_fd", "darcy"])
def test_cuda_placed_graphs_across_two_cards(cuda, kind):
    """Blocks round robin over cuda:0 and cuda:1 (skips on one card): a
    ``sync: False`` solve is one CUDA graph per card (the loops WHILE nodes
    of each card's graph, the blocks joined by ``ops.peer``'s put and wait
    kernels); the first call warms and captures, then 3 replays each give
    the ``sync: True`` solve's ``itr`` and bits on the same cards, with no
    host sync. With the CG case, the fused LES across the same cards, its
    state whole: one graph per card per step, the eager steps' bits
    (``_fused_les_across``); with the MG case, the same with its state on
    the blocks, four per card."""
    from pyapes_tpu_torch.ops import graph_loop, peer

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards; this machine shows {n}")
    devs = ("cuda:0", "cuda:1") * 4
    solve = _placed_graph_problem(cuda, kind, "blocks" if kind != "cg" else "whole", devs)
    ref, rref = solve(True)
    assert rref["converge"]
    puts = peer.peer_put.launches
    solve(False)  # the warm-up and the capture
    assert peer.peer_put.launches > puts
    nodes = graph_loop.nodes
    for _ in range(3):
        torch.cuda.synchronize(0)
        torch.cuda.synchronize(1)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, rep = solve(False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert isinstance(rep["itr"], torch.Tensor) and rep["itr"].dim() == 0
        assert int(rep["itr"]) == rref["itr"] and float(rep["tol"]) == rref["tol"]
        assert len(out) == len(ref) and all(torch.equal(a, b) for a, b in zip(out, ref))
    assert graph_loop.nodes == nodes  # replays, not captures
    if kind == "cg":
        _fused_les_across(cuda, devs, on_blocks=False)
    elif kind == "mg":  # the state on the blocks, four per card
        _fused_les_across(cuda, devs, on_blocks=True)


def _fused_les_across(dev, devs, on_blocks: bool):
    """The 17^3 f64 LES of ``_fused_placed_models`` with its solves on
    ``devs`` (blocks on several cards) and its state whole or on the blocks:
    eager and fused (no fallback: the warning is an error) two steps, then
    3 steps each; every fused step one replay per card with no host sync,
    the eager step's ``itr`` solve by solve; at the end the same bits of
    every state Field's value and history."""
    import warnings

    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks
    from pyapes_tpu_torch.solver.ops import solve_log

    m1, m2, dt = _fused_placed_models(dev, devs, n=17)
    if on_blocks:
        dd = DomainDecomposition((4, 2, 1), devices=devs)
        m1.put_state(dd)
        m2.put_state(dd)
    cards = sorted({str(d) for d in m2.p_solver.config["fdm"]["decomp"].devices})
    real = torch.cuda.CUDAGraph.replay
    replays = [0]

    def counted(graph):
        replays[0] += 1
        return real(graph)

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m1.run(dt, 2)
        m2.run(dt, 2, fused=True)
        runner = m2.fused_runner()
        for _ in range(3):
            with solve_log() as log:
                m1.step(dt)
            for c in cards:
                torch.cuda.synchronize(c)
            replays[0] = 0
            torch.cuda.CUDAGraph.replay = counted
            torch.cuda.set_sync_debug_mode("error")
            try:
                runner.step(dt)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.CUDAGraph.replay = real
            assert replays[0] == len(cards)
            assert [int(r["itr"]) for r in runner.reports] == [int(r["itr"]) for r in log]
    assert runner.captures == 1
    assert len(next(iter(runner._compiled.values())).call.graphs) == len(cards)

    def parts(x):
        return list(x.parts) if isinstance(x, blocks.BlockTensor) else [x]

    for a, b in zip(m1.state_fields(), m2.state_fields()):
        assert isinstance(b(), blocks.BlockTensor) == on_blocks
        for lvl in ("_VAR", "_VARo"):
            assert all(torch.equal(x, y) for x, y in zip(parts(getattr(a, lvl)),
                                                          parts(getattr(b, lvl)))), a.name


def _bench_mg_problem(dev, n: int, devs):
    """Bench's MG-PCG (CG, bf16 V(2,2), omega 0.857, FMG, ``fuse_rz``; tol
    1e-6, the residual criterion) on an ``n``^3 f32 unit cube, homogeneous
    Dirichlet faces, a seeded RHS, the Field and the RHS on ``(4, 2, 1)``
    blocks on ``devs``. Returns ``solve(sync) -> (the solution's blocks,
    cloned; the report)``, each call from zeros."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks
    from pyapes_tpu_torch.solver import FDM, Solver
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    dd = DomainDecomposition((4, 2, 1), devices=devs)
    mesh = Mesh(Box[(slice(0, 1),) * 3], None, [n] * 3, device=str(dev), dtype="single")
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet"),
                               "obstacle": None}, init_val=0.0)
    rng = np.random.default_rng(0)
    rhs = blocks.put(torch.from_numpy(rng.standard_normal((1, n, n, n)).astype(np.float32)), dd)
    zeros = blocks.put(torch.zeros((1, n, n, n)), dd)
    cfg = {"method": "cg", "precond": "mg", "tol": 1e-6, "max_it": 200, "criterion": "residual",
           "report": False, "decomp": dd,
           "mg_opts": {"dtype": "bfloat16", "n_pre": 2, "n_post": 2, "omega": 0.857,
                       "fmg": True, "fuse_rz": True}}
    solvers = {sync: Solver({"fdm": {**cfg, "sync": sync}}) for sync in (True, False)}

    def solve(sync):
        var.VAR = zeros.clone()
        solvers[sync].set_eq(FDM().laplacian(1.0, var) == rhs)
        rep = solvers[sync].solve()
        return [p.clone() for p in var().parts], rep

    return solve


@pytest.mark.parametrize("n", [64, 256])
def test_cuda_bench_mgpcg_across_two_cards(cuda, n):
    """Bench's bf16 V(2,2) FMG MG-PCG with its blocks round robin over
    cuda:0 and cuda:1 (skips on one card), four blocks per card: ``sync:
    False`` is one graph per card, captured at the first call, and 3
    replays each give the ``sync: True`` solve's ``itr``, ``tol`` and
    solution bits (at 256^3 too, where such graphs once segfaulted at their
    first launch: ``scripts/mg_across_matrix_torch.py``)."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip(f"needs two cards; this machine shows {n_cards}")
    solve = _bench_mg_problem(cuda, n, ("cuda:0", "cuda:1") * 4)
    ref, rref = solve(True)
    assert rref["converge"]
    solve(False)  # the warm-up and the capture
    for _ in range(3):
        out, rep = solve(False)
        assert int(rep["itr"]) == rref["itr"] and float(rep["tol"]) == rref["tol"]
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_cuda_lanes_capture_of_a_placed_solve(cuda):
    """A user's capture of one graph per card holding a placed ``sync:
    False`` solve (skips on one card): ``GraphedCall(fn, "cuda:0",
    lanes=blocks.card_lanes(dd, "cuda:0"))`` with the Field's initial guess
    and the RHS as its inputs, 3 replays after the capture: the ``sync:
    True`` solve's bits, ``itr`` and ``tol``; one graph per card. A capture of
    one graph (no lanes) of the same solve raises ``NotImplementedError``
    naming A11f."""
    from pyapes_tpu_torch.ops.graph_loop import GraphedCall
    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip(f"needs two cards; this machine shows {n_cards}")
    devs = ("cuda:0", "cuda:1") * 4
    solve = _bench_mg_problem(cuda, 64, devs)
    ref, rref = solve(True)
    lanes = blocks.card_lanes(DomainDecomposition((4, 2, 1), devices=devs), "cuda:0")
    assert [str(d) for d in lanes] == ["cuda:0", "cuda:1"]

    def fn():
        out, rep = solve(False)
        return out, rep["itr"], rep["tol"]

    call = GraphedCall(fn, "cuda:0", lanes=lanes)
    call()  # the warm-up and the capture
    assert len(call.graphs) == 2
    for _ in range(3):
        out, itr, tol = call()
        for c in lanes:
            torch.cuda.synchronize(c)
        assert int(itr) == rref["itr"] and float(tol) == rref["tol"]
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    with pytest.raises(NotImplementedError, match="A11f"):
        GraphedCall(fn, "cuda:0")()


# -- the peer put / wait kernels ---------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_peer_put_wait_equal_plain(cuda, dtype):
    """``peer_put`` + ``peer_wait`` on one card (the put on one stream, the
    wait on another) against the plain ``dst.copy_(src)``: every ghost face
    of a (4, 2, 1) block of 64^3 into its slot of the halo-extended buffer,
    a block into its place in the whole grid, stacked partials; bits equal,
    the rest of the destination untouched; one channel reused 3 times (its
    counters only grow)."""
    from pyapes_tpu_torch.ops import peer

    g = torch.Generator(device="cpu").manual_seed(3)
    block = torch.randn((2, 16, 32, 64), generator=g).to(cuda, dtype)
    cases = []
    for j in range(3):
        shape = [2] + [n + 2 * (k == j) for k, n in enumerate((16, 32, 64))]
        buf = torch.zeros(shape, dtype=dtype, device=cuda)
        idx = [slice(None)] + [slice(0, 1) if k == j else slice(int(k == j), int(k == j) + n)
                               for k, n in enumerate((16, 32, 64))]
        cases.append((block.narrow(1 + j, 15 if j == 0 else (31 if j == 1 else 63), 1), buf,
                      buf[tuple(idx)]))
    whole = torch.zeros((2, 64, 64, 64), dtype=dtype, device=cuda)
    cases.append((block, whole, whole[:, 16:32, 32:64, :]))
    parts = torch.randn((4, 2, 1, 1, 1), generator=g).to(cuda, dtype)
    stack = torch.zeros_like(parts)
    cases.append((parts, stack, stack))
    sa, sb = torch.cuda.Stream(), torch.cuda.Stream()
    for src, buf, view in cases:
        ref = buf.clone()
        ref.as_strided(view.shape, view.stride(),
                       view.storage_offset() - buf.storage_offset()).copy_(src)
        ch = peer.Channel.make(cuda, cuda)
        torch.cuda.synchronize()
        for _ in range(3):
            with torch.cuda.stream(sb):
                peer.peer_wait(ch)
            with torch.cuda.stream(sa):
                peer.peer_put(src, view, ch)
        torch.cuda.synchronize()
        assert torch.equal(buf, ref)
        assert ch.src.tolist() == [3, 3, 0] and ch.dst.tolist() == [3, 3]


def test_cuda_peer_wait_without_put_ends_with_an_error():
    """A ``peer_wait`` whose put never comes ends within its bound
    (``TIMEOUT_S`` 0.5 s) with an error, in a process of its own (the trap
    leaves the context unusable): never a hang."""
    import os
    import subprocess
    import sys
    import time

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    code = ("import torch; from pyapes_tpu_torch.ops import peer; peer.TIMEOUT_S = 0.5; "
            "ch = peer.Channel.make('cuda:0', 'cuda:0'); torch.cuda.synchronize(); "
            "peer.peer_wait(ch); torch.cuda.synchronize(); print('no error')")
    tic = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert run.returncode != 0 and "no error" not in run.stdout
    assert "launch failure" in run.stderr or "error" in run.stderr.lower()
    assert time.perf_counter() - tic < 90


# -- the last options on placed blocks; block Fields on periodic axes -------

OPT_CASES = ["obstacle_mg", "obstacle_bicgstab", "custom_fd", "per_iteration", "donate",
             "debug_nan"]


def _opt_devices(placement):
    if placement == "two_cards" and torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards; this machine shows {torch.cuda.device_count()}")
    return {"one_card": ("cuda:0",) * 8, "two_cards": ("cuda:0", "cuda:1") * 4}[placement]


def _opt_problem(dev, case, dd, on_blocks, calls):
    """A (4, 2, 1)-cut 32 x 32 x 64 f64 problem of ``case`` (the options of
    ``tests/test_torch_placed_options.py``): ``(var, lhs, rhs, cfg)``, the
    Field and RHS on ``dd``'s blocks with ``on_blocks``."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.parallel import blocks
    from pyapes_tpu_torch.solver import FDM
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    nx = (32, 32, 64)
    obstacles = {"obstacle_mg": [Box[0.2:0.45, 0.3:0.6, 0.3:0.6], Box[0.6:0.8, 0.35:0.65,
                                                                    0.4:0.7]],
                 "obstacle_bicgstab": [Box[0.3:0.55, 0.2:0.45, 0.35:0.6]]}.get(case)
    mesh = Mesh(Box[0:1, 0:1, 0:1], obstacles, list(nx), device=str(dev), dtype="double")
    bcs = homogeneous_bcs(3, 0.0, "dirichlet")
    if case == "per_iteration":
        bcs[1] = {"bc_face": "xu", "bc_type": "dirichlet", "bc_val_opt": {"per_iteration": True},
                  "bc_val": lambda grid, mask, var, opt: 0.5 * torch.mean(var)}
    obs = {"obstacle_mg": [{"bc_type": "dirichlet", "bc_val": 1.0},
                           {"bc_type": "neumann", "bc_val": 2.0}],
           "obstacle_bicgstab": [{"bc_type": "neumann", "bc_val": 0.0}]}.get(case)
    var = Field("p", 1, mesh, {"domain": bcs, "obstacle": obs}, init_val=0.0)
    g = torch.Generator(device="cpu").manual_seed(5)
    rhs = torch.randn((1, *nx), generator=g, dtype=torch.float64).to(dev)
    cfg = {"method": "cg", "tol": 1e-10, "max_it": 400, "criterion": "residual",
           "precond": "mg", "report": False}
    fdm = FDM()
    lhs = lambda: fdm.laplacian(1.0, var)  # noqa: E731
    if case == "obstacle_bicgstab":
        cfg["method"] = "bicgstab"
    elif case == "custom_fd":
        w = (1.0 + 0.2 * torch.rand(nx, generator=g, dtype=torch.float64)).to(dev)

        def op(x, c):
            calls.append(1)
            return 6.0 * c * x - 0.9 * sum(torch.roll(x, s, a) for a in (1, 2, 3)
                                           for s in (1, -1))

        hint = tuple(tuple([v] * n for v in (-0.9, 2.2, -0.9)) for n in nx)
        lhs = lambda: fdm.custom(op, var, params=(w,), fd_hint=hint)  # noqa: E731
        cfg.update({"method": "bicgstab", "precond": "fd"})
    elif case == "donate":
        cfg["donate"] = True
    elif case == "debug_nan":
        cfg["debug"] = "nan"
    if on_blocks:
        var.VAR = blocks.put(var(), dd)
        rhs = blocks.put(rhs, dd)
    return var, lhs, rhs, cfg


@pytest.mark.parametrize("placement", ["one_card", "two_cards"])
@pytest.mark.parametrize("case", OPT_CASES)
def test_cuda_placed_options_on_block_fields(cuda, case, placement):
    """Each last option with the Field on (4, 2, 1) blocks on the card (or
    round robin over two, skips on one) against the view-based solve of the
    whole Field on the card: the same ``itr`` (BiCGSTAB: the solution, its
    count moves with the dots' order), 1e-12, the solution on the blocks
    (``donate``: in their storage); gathers only the V-cycle's hand-over,
    one per custom apply, two ``per_iteration`` ones per CG solve; a NaN
    in a block off the lead raises ``NaNError`` without a gather."""
    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks
    from pyapes_tpu_torch.solver import Solver, multigrid
    from pyapes_tpu_torch.utils.debug import NaNError

    devices = _opt_devices(placement)
    dd = DomainDecomposition((4, 2, 1), devices=devices)
    out = {}
    for kind in ("view", "blocks"):
        calls = []
        var, lhs, rhs, cfg = _opt_problem(cuda, case, dd, kind == "blocks", calls)
        ptrs = [p.data_ptr() for p in var().parts] if kind == "blocks" else None
        s = Solver({"fdm": {**cfg, "decomp": dd if kind == "blocks"
                            else DomainDecomposition((4, 2, 1))}})
        s.set_eq(lhs() == rhs)
        g0, c0, p0 = blocks.gathers, multigrid.cycle_gathers, blocks.per_iteration_gathers
        rep = s.solve()
        gathers = blocks.gathers - g0 - (multigrid.cycle_gathers - c0)
        out[kind] = (var().cpu(), rep)
    if case == "donate":
        assert [p.data_ptr() for p in var().parts] == ptrs
    assert isinstance(var(), blocks.BlockTensor)
    (x, rep), (ref, rref) = out["blocks"], out["view"]
    assert rep["converge"] and rref["converge"]
    if rep["itr"] != rref["itr"]:
        assert "bicgstab" in case or case == "custom_fd", (rep, rref)
        np.testing.assert_allclose(x.numpy(), ref.numpy(), atol=1e-9, rtol=0)
    else:
        np.testing.assert_allclose(x.numpy(), ref.numpy(), atol=1e-12, rtol=0)
    if case == "custom_fd":
        assert calls and gathers == len(calls)
    elif case == "per_iteration":
        assert blocks.per_iteration_gathers - p0 == 2 and gathers == 2
    else:
        assert gathers == 0
    if case == "debug_nan":
        var, lhs, rhs, cfg = _opt_problem(cuda, case, dd, False, [])
        rhs[0, 27, 20, 50] = float("nan")
        var.VAR = blocks.put(var(), dd)
        s = Solver({"fdm": {**cfg, "decomp": dd}})
        s.set_eq(lhs() == blocks.put(rhs, dd))
        g0, c0 = blocks.gathers, multigrid.cycle_gathers
        with pytest.raises(NaNError):
            s.solve()
        assert blocks.gathers - g0 == multigrid.cycle_gathers - c0


def _les_state(dev, devices, on_blocks, fused, n=17, steps=3):
    """The Smagorinsky TGV-3D LES (f64, ``n``^3) with its solves on (2, 2, 1)
    blocks on ``devices``, the state whole or on the blocks, ``steps``
    steps: ``(itr per solve, the state on the host)``."""
    from math import pi

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import PeriodicFlow
    from pyapes_tpu_torch.models.navier_stokes import smagorinsky_viscosity
    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks
    from pyapes_tpu_torch.solver.ops import solve_log

    dd = DomainDecomposition((2, 2, 1), devices=devices)
    mesh = Mesh(Box[0:2 * pi, 0:2 * pi, 0:2 * pi], None, [n] * 3, device=str(dev),
                dtype="double")
    m = PeriodicFlow(mesh, nu=1 / 1600, config={"decomp": dd},
                     mu_strain_fn=smagorinsky_viscosity(1 / 1600, mesh))
    X, Y, Z = mesh.grid
    m.set_velocity(torch.sin(X) * torch.cos(Y) * torch.cos(Z),
                   -torch.cos(X) * torch.sin(Y) * torch.cos(Z), torch.zeros_like(X))
    if on_blocks:
        m.put_state(dd)
    dt = 0.2 * 2 * pi / (n - 1)
    g0 = blocks.gathers
    with solve_log() as log:
        m.run(dt, steps, fused=fused)
    assert blocks.gathers == g0
    if on_blocks:
        assert all(isinstance(f(), blocks.BlockTensor) for f in m.state_fields())
    return [int(r["itr"]) for r in log], [f().cpu() for f in m.state_fields()]


@pytest.mark.parametrize("placement", ["one_card", "two_cards"])
def test_cuda_placed_les_with_its_state_on_blocks(cuda, placement):
    """The LES with its state on (2, 2, 1) blocks (the seam planes in the
    last blocks, the glue's rolls across the blocks' faces) against its
    whole-state placed run: the same ``itr`` per solve, 1e-12, no gather;
    on one card the fused run (one graph per step) too."""
    devices = _opt_devices(placement)[:4]
    blk, whole = (_les_state(cuda, devices, b, False) for b in (True, False))
    assert blk[0] == whole[0]
    for a, b in zip(blk[1], whole[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12, rtol=0)
    if placement == "one_card":
        fused = _les_state(cuda, devices, True, True)
        for a, b in zip(fused[1], blk[1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12, rtol=0)
