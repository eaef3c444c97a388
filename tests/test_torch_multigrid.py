"""Parity of the port's multigrid hierarchy and V-cycle with the JAX
package (CPU).

The hierarchy is host numpy in both packages (level shapes, 1/dx^2,
surgered level coefficients, symmetrization scales, boundary-extension
and transfer matrices), built by the same code from the same inputs: it
must be BIT-equal. One V-cycle (``preconditioner()``,
``preconditioner_dot()``) and one FMG pass on the same residual agree to
1e-12 relative in float64 (the same arithmetic in another summation
order): Dirichlet, mixed Neumann and all-Neumann singular hierarchies,
both transfer modes, and the JAX Pallas kernel tier (interpret mode).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.solver import multigrid as jmg  # noqa: E402
from pyapes_tpu_torch.parallel import DomainDecomposition  # noqa: E402
from pyapes_tpu_torch.solver import multigrid as pmg  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

N = ("neumann", "neumann")
D = ("dirichlet", "dirichlet")
ND = ("neumann", "dirichlet")
CASES = {
    "dirichlet": ((9, 17, 33), None),
    "mixed": ((12, 10, 9), (ND, D, ("dirichlet", "neumann"))),
    "all_neumann": ((9, 9, 9), (N, N, N)),
    "mixed_2d": ((17, 13), (ND, D)),
}


def _pair(case, transfers="strided", use_pallas=False, **opts):
    shape, fk = CASES[case] if isinstance(case, str) else case
    lengths = [1.0, 2.0, 0.5][: len(shape)]
    j = jmg.MGSpec(shape, lengths, dtype=jnp.float64, face_kinds=fk, transfers=transfers,
                   use_pallas=use_pallas, **opts)
    p = pmg.MGSpec(shape, lengths, dtype=torch.float64, face_kinds=fk, transfers=transfers,
                   device="cpu", **opts)
    return j, p


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_hierarchy_bit_equal(case):
    j, p = _pair(case)
    assert p.shapes == j.shapes and p._surgery == j._surgery and p._singular == j._singular
    for shape in j.shapes:
        assert p._inv_dx2(shape) == j._inv_dx2(shape)
        for jc, pc in zip(j._level_coeffs(shape, jnp.float64), p._level_coeffs_np(shape)):
            for a, b in zip(jc, pc):
                assert np.array_equal(np.asarray(a), b)
        for ax, n in enumerate(shape):
            assert np.array_equal(j._dvec_np(n, ax), p._dvec_np(n, ax))
            assert np.array_equal(j._bc_extend_matrix_np(n, ax), p._bc_extend_matrix_np(n, ax))
    for fine, coarse in zip(j.shapes, j.shapes[1:]):
        for ax, (nf, nc) in enumerate(zip(fine, coarse)):
            assert np.array_equal(jmg._interp_matrix_np(nc, nf), pmg._interp_matrix_np(nc, nf))
            for ns, nt in ((nf, nc), (nc, nf)):
                assert np.array_equal(j._transfer_matrix_np(ns, nt, ax),
                                      p._transfer_matrix_np(ns, nt, ax))


def test_level_shapes_512():
    assert pmg._level_shapes((512,) * 3) == jmg._level_shapes((512,) * 3)
    assert len(pmg._level_shapes((512,) * 3)) == 8


def _residual(shape, seed, singular):
    r = np.random.default_rng(seed).standard_normal((1,) + shape)
    inner = (slice(None),) + (slice(1, -1),) * len(shape)
    m = np.zeros_like(r)
    m[inner] = 1.0
    r = r * m
    if singular:
        r = (r - r.sum() / m.sum()) * m
    return r


@pytest.mark.parametrize("transfers", ["strided", "matrix"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_vcycle_and_fmg_match_jax(case, transfers):
    j, p = _pair(case, transfers)
    r = _residual(j.shape, 3, j._singular)
    assert _rel(p.preconditioner()(torch.from_numpy(r)).numpy(),
                j.preconditioner()(jnp.asarray(r))) <= 1e-12
    assert _rel(p.fmg(torch.from_numpy(r)).numpy(), j.fmg(jnp.asarray(r))) <= 1e-12


@pytest.mark.parametrize("opts", [
    {"n_pre": 2, "n_post": 2, "omega": 0.857, "fuse_rz": True},
    {"n_pre": 1, "n_post": 1, "fuse_rz": True},
    {"n_pre": 3, "n_post": 3, "n_coarse": 5, "fuse_rz": True},
])
def test_preconditioner_dot_matches_jax_pallas(opts):
    """The fused r.z V-cycle against the JAX Pallas tier (x2 pairs, the
    single sweep for odd counts, the dot-emitting last smooth)."""
    case = ((16, 16, 128), None)
    j, p = _pair(case, "strided", use_pallas=True, **opts)
    assert p.can_fuse_rz() and j.can_fuse_rz()
    r = _residual(case[0], 4, False)
    jz, jrz = j.preconditioner_dot()(jnp.asarray(r))
    pz, prz = p.preconditioner_dot()(torch.from_numpy(r))
    assert _rel(pz.numpy(), jz) <= 1e-12
    assert tuple(prz.shape) == (1, 1, 1, 1)
    assert abs(prz.item() - float(jrz.ravel()[0])) <= 1e-12 * np.abs(r * np.asarray(jz)).sum()
    assert _rel(p.preconditioner()(torch.from_numpy(r)).numpy(), jz) <= 1e-12


@pytest.mark.parametrize("smoother", ["rbgs", "chebyshev"])
def test_other_smoothers_match_jax(smoother):
    j, p = _pair("mixed", "matrix", smoother=smoother)
    r = _residual(j.shape, 5, False)
    assert _rel(p.preconditioner()(torch.from_numpy(r)).numpy(),
                j.preconditioner()(jnp.asarray(r))) <= 1e-12


def test_bf16_cycle_dtype_and_cast_shell():
    """The cycle runs in bf16 and casts back; it stays an approximation of
    the f64 cycle to bf16 accuracy."""
    _, p64 = _pair("dirichlet")
    _, p16 = _pair("dirichlet", cycle_dtype="bfloat16")
    assert p16.cdtype == torch.bfloat16
    r = torch.from_numpy(_residual(p64.shape, 6, False))
    z16 = p16.preconditioner()(r)
    assert z16.dtype == torch.float64
    assert _rel(z16.numpy(), p64.preconditioner()(r).numpy()) <= 5e-2


def test_unported_options_raise():
    """A block on a device the machine lacks raises, and a placed
    decomposition (blocks on their own devices) builds; periodic axes (an rz
    hierarchy's too) build, as in the JAX package (their numerics:
    ``tests/test_torch_periodic.py``); an rz hierarchy takes no variable Γ
    (an assertion, as in the JAX package); a decomp of another type than
    ``DomainDecomposition`` is refused too."""
    with pytest.raises(ValueError, match="not a CPU or CUDA device"):
        DomainDecomposition((3, 1, 1), devices=("cpu", "meta", "cpu"))
    placed = DomainDecomposition((3, 1, 1), devices=("cpu",) * 3)
    assert pmg.MGSpec((9, 9, 9), (1.0, 1.0, 1.0), device="cpu", decomp=placed).decomp is placed
    for kw in ({"paxes": (0,)}, {"paxes": (1,), "rz": True}):
        spec = pmg.MGSpec((8, 8, 9), (1.0, 1.0, 1.0), device="cpu", **kw)
        assert spec.paxes == kw["paxes"] and spec.shapes == jmg._level_shapes((8, 8, 9))
    with pytest.raises(AssertionError):
        pmg.MGSpec((9, 9), (1.0, 1.0), device="cpu", rz=True, var_gamma=True)
    with pytest.raises(TypeError):
        pmg.MGSpec((9, 9, 9), (1.0, 1.0, 1.0), device="cpu", decomp=object())
