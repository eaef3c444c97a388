"""The adjoint tier (``solver/adjoint.py``) against the JAX package (CPU,
float64): the sixteen tests of ``tests/test_adjoint.py`` by name, each on
the same seeded inputs through both packages, plus the JAX tests' own
gates on the port; the hand-written transpose and Γ-gradient of the
variable-Γ operator against ``torch.func.vjp`` and ``jax.vjp``; and a CPU
gradient that counts no kernel launch.

Tolerances: both packages run the same Krylov loops in another summation
order, so forward solutions agree to 1e-10 relative and gradients to 1e-8
(each solve stops within ``tol`` of its system); the hand-written helpers
are exact linear algebra of the same operator, so they agree to 1e-12.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.ops.stencil import apply_diff_field as japply_diff_field  # noqa: E402
from pyapes_tpu.ops.stencil import div_axis_coeffs as jdiv_axis_coeffs  # noqa: E402
from pyapes_tpu.ops.stencil import laplacian_axis_coeffs as jlaplacian_axis_coeffs  # noqa: E402
from pyapes_tpu.solver import adjoint as jadj  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu.variables.bcs import mixed_bcs as jmixed_bcs  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops import axis_stencil as axis_mod  # noqa: E402
from pyapes_tpu_torch.ops import diff_field as diff_mod  # noqa: E402
from pyapes_tpu_torch.ops.stencil import apply_axis_stencil, apply_diff_field  # noqa: E402
from pyapes_tpu_torch.ops.stencil import div_axis_coeffs, laplacian_axis_coeffs  # noqa: E402
from pyapes_tpu_torch.solver import DifferentiableDiffusionSolve, DifferentiableSolve  # noqa: E402
from pyapes_tpu_torch.solver.adjoint import (  # noqa: E402
    DifferentiableTransient,
    DifferentiableTransientDiffusion,
    diff_field_gamma_vjp,
    diff_field_transpose,
    transpose_axis_coeffs,
)
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import mixed_bcs  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

F64 = torch.float64
X_TOL = 1e-10  # forward solutions, relative to the largest entry
G_TOL = 1e-8  # gradients, relative to the largest entry
HELPER_TOL = 1e-12


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _tcoeffs(coeffs):
    return tuple(tuple(_t(c) for c in cs) for cs in coeffs)


def _jcoeffs(coeffs):
    return tuple(tuple(jnp.asarray(np.asarray(c)) for c in cs) for cs in coeffs)


def _meshes(n, dims=2):
    box = tuple(slice(0, 1) for _ in range(dims))
    return (JMesh(JBox[box], None, [n] * dims),
            Mesh(Box[box], None, [n] * dims, device="cpu", dtype="double"))


def _fields(n, bc_types, name="p"):
    jm, pm = _meshes(n)
    jv = JField(name, 1, jm, {"domain": jmixed_bcs([0.0] * 4, list(bc_types)), "obstacle": None},
                init_val=0.0)
    pv = Field(name, 1, pm, {"domain": mixed_bcs([0.0] * 4, list(bc_types)), "obstacle": None},
               init_val=0.0)
    return jm, jv, pm, pv


def _setup(n=17, bc_types=("dirichlet",) * 4):
    """The JAX test's ``_setup`` in both packages: ``(jax (mesh, var,
    coeffs, dsolve), port (mesh, var, coeffs, dsolve), rhs as numpy)``."""
    jm, jv, pm, pv = _fields(n, bc_types)
    jc = jlaplacian_axis_coeffs(jm, jv.bcs)
    pc = _tcoeffs(laplacian_axis_coeffs(pm, pv.bcs))
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal((1, n, n))
    return ((jm, jv, jc, jadj.DifferentiableSolve(jm, jv.bcs, tol=1e-12, max_it=2000)),
            (pm, pv, pc, DifferentiableSolve(pm, pv.bcs, tol=1e-12, max_it=2000)), rhs)


def _grad(loss, x: torch.Tensor) -> torch.Tensor:
    x = x.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(x), x)
    return g


def test_forward_matches_plain_solver() -> None:
    """The port's differentiable solve equals the JAX package's and the
    port's plain solver machinery (identical operator + interior
    restriction)."""
    from pyapes_tpu_torch.solver import FDM, Solver

    (_, _, jc, jds), (pm, pv, pc, pds), rhs = _setup()
    x = pds(pc, _t(rhs))
    assert _rel(x, jds(jc, jnp.asarray(rhs))) < X_TOL
    solver = Solver({"fdm": {"method": "cg", "tol": 1e-12, "max_it": 2000, "report": False,
                             "criterion": "residual"}})
    solver.set_eq(FDM().laplacian(1.0, pv) == _t(rhs))
    solver.solve()
    assert_allclose(x.numpy(), pv().numpy(), atol=1e-9)


def test_grad_wrt_rhs_vs_finite_difference() -> None:
    """d/d(rhs) of sum(x^2): the port's adjoint gradient equals JAX's and
    central differences."""
    (_, _, jc, jds), (_, _, pc, pds), rhs = _setup()

    def loss(b):
        return torch.sum(pds(pc, b) ** 2)

    g = _grad(loss, _t(rhs))
    gj = jax.grad(lambda b: jnp.sum(jds(jc, b) ** 2))(jnp.asarray(rhs))
    assert _rel(g, gj) < G_TOL
    eps = 1e-5
    rng = np.random.default_rng(1)
    for _ in range(4):
        i, j = rng.integers(1, 16, size=2)
        e = torch.zeros(1, 17, 17, dtype=F64)
        e[0, i, j] = 1.0
        fd = (float(loss(_t(rhs) + eps * e)) - float(loss(_t(rhs) - eps * e))) / (2 * eps)
        assert_allclose(g[0, i, j].item(), fd, rtol=2e-5, atol=1e-8)


def test_grad_wrt_coefficients() -> None:
    """Gradients flow to the stencil coefficients: d/d(gamma) of sum(x)
    with A = gamma * Laplacian, against JAX, central differences and the
    analytic -sum(x)/gamma."""
    (_, _, jc, jds), (_, _, pc, pds), rhs = _setup()
    b = _t(rhs)

    def loss(gamma):
        return torch.sum(pds(tuple(tuple(gamma * c for c in cs) for cs in pc), b))

    g = _grad(loss, torch.tensor(2.0, dtype=F64)).item()
    gj = float(jax.grad(lambda gm: jnp.sum(jds(tuple(tuple(gm * c for c in cs) for cs in jc),
                                                  jnp.asarray(rhs))))(2.0))
    assert abs(g - gj) <= G_TOL * abs(gj)
    eps = 1e-4
    two = torch.tensor(2.0, dtype=F64)
    fd = (float(loss(two + eps)) - float(loss(two - eps))) / (2 * eps)
    assert_allclose(g, fd, rtol=1e-5)
    assert_allclose(g, -float(loss(two)) / 2.0, rtol=1e-6)


def test_grad_nonlinear_loss_and_value_gate() -> None:
    """A nonlinear functional matches JAX and finite differences;
    non-homogeneous BC values are rejected with a clear message (the port
    raises ValueError where the JAX package asserts)."""
    (_, _, jc, jds), (pm, _, pc, pds), rhs = _setup()

    def loss(b):
        return torch.sum(torch.sin(pds(pc, b)))

    g = _grad(loss, _t(rhs))
    gj = jax.grad(lambda b: jnp.sum(jnp.sin(jds(jc, b))))(jnp.asarray(rhs))
    assert _rel(g, gj) < G_TOL
    eps = 1e-5
    e = torch.zeros(1, 17, 17, dtype=F64)
    e[0, 7, 9] = 1.0
    fd = (float(loss(_t(rhs) + eps * e)) - float(loss(_t(rhs) - eps * e))) / (2 * eps)
    assert_allclose(g[0, 7, 9].item(), fd, rtol=5e-5, atol=1e-8)

    var2 = Field("p", 1, pm, {"domain": mixed_bcs([1.0, 0.0, 0.0, 0.0], ["dirichlet"] * 4),
                              "obstacle": None})
    with pytest.raises(ValueError, match="homogeneous"):
        DifferentiableSolve(pm, var2.bcs)


def test_inverse_problem_source_recovery() -> None:
    """Recover two source amplitudes by gradient descent on the solution
    mismatch (the JAX test's 200 steps of lr 3e3, atol 1e-2); the first
    gradient equals JAX's."""
    (_, _, jc, jds), (_, _, pc, pds), _ = _setup()
    e1 = torch.zeros(1, 17, 17, dtype=F64)
    e1[0, 5, 11] = 1.0
    e2 = torch.zeros(1, 17, 17, dtype=F64)
    e2[0, 12, 4] = 1.0
    a_true = torch.tensor([-3.0, 2.0], dtype=F64)
    x_obs = pds(pc, a_true[0] * e1 + a_true[1] * e2)
    j1, j2, jx_obs = jnp.asarray(e1.numpy()), jnp.asarray(e2.numpy()), jnp.asarray(x_obs.numpy())

    def loss(a):
        return torch.sum((pds(pc, a[0] * e1 + a[1] * e2) - x_obs) ** 2)

    g0 = _grad(loss, torch.zeros(2, dtype=F64))
    gj = jax.grad(lambda a: jnp.sum((jds(jc, a[0] * j1 + a[1] * j2) - jx_obs) ** 2))(
        jnp.zeros(2))
    assert _rel(g0, gj) < G_TOL
    a = torch.zeros(2, dtype=F64)
    for _ in range(200):
        a = a - 3e3 * _grad(loss, a)
    assert_allclose(a.numpy(), a_true.numpy(), atol=1e-2)


def test_transpose_axis_coeffs_is_exact() -> None:
    """The analytic stencil transpose equals the vjp of the roll-based
    apply in the port (torch.func) and JAX's transpose of its apply."""
    from pyapes_tpu.ops.stencil import apply_axis_stencil as japply

    rng = np.random.default_rng(5)
    coeffs = tuple(tuple(rng.standard_normal(n) for _ in range(3)) for n in (9, 11))
    x = rng.standard_normal((1, 9, 11))
    y = rng.standard_normal((1, 9, 11))
    tc = _tcoeffs(coeffs)
    _, vjp = torch.func.vjp(lambda v: apply_axis_stencil(tc, v), _t(x))
    (via_vjp,) = vjp(_t(y))
    via_analytic = apply_axis_stencil(transpose_axis_coeffs(tc), _t(y))
    assert_allclose(via_analytic.numpy(), via_vjp.numpy(), atol=1e-12)
    jc = _jcoeffs(coeffs)
    (via_jax,) = jax.linear_transpose(lambda v: japply(jc, v), jnp.asarray(x))(jnp.asarray(y))
    assert_allclose(via_analytic.numpy(), np.asarray(via_jax), atol=1e-12)


def test_grad_mixed_neumann_poisson() -> None:
    """Mixed Dirichlet/Neumann Poisson (nonsymmetric surgered operator,
    the transpose solve): the port's gradient equals JAX's and finite
    differences."""
    (_, _, jc, _), (pm, pv, pc, _), _ = _setup(
        bc_types=("neumann", "dirichlet", "neumann", "dirichlet"))
    jm, jv, _, _ = _fields(17, ("neumann", "dirichlet", "neumann", "dirichlet"))
    jds = jadj.DifferentiableSolve(jm, jv.bcs, tol=1e-12)
    pds = DifferentiableSolve(pm, pv.bcs, tol=1e-12)
    rng = np.random.default_rng(2)
    rhs = rng.standard_normal((1, 17, 17))

    def loss(b):
        return torch.sum(pds(pc, b) ** 2)

    assert _rel(pds(pc, _t(rhs)), jds(jc, jnp.asarray(rhs))) < X_TOL
    g = _grad(loss, _t(rhs))
    gj = jax.grad(lambda b: jnp.sum(jds(jc, b) ** 2))(jnp.asarray(rhs))
    assert _rel(g, gj) < G_TOL
    eps = 1e-6
    for idx in ((0, 5, 7), (0, 1, 8), (0, 15, 3)):
        e = torch.zeros(1, 17, 17, dtype=F64)
        e[idx] = 1.0
        fd = (float(loss(_t(rhs) + eps * e)) - float(loss(_t(rhs) - eps * e))) / (2 * eps)
        assert_allclose(g[idx].item(), fd, rtol=2e-4, atol=5e-7)


def _transport_coeffs(lap, div, dt, nu):
    return tuple((div[j][0] - nu * lap[j][0],
                  div[j][1] - nu * lap[j][1] + (1.0 / dt if j == 0 else 0.0),
                  div[j][2] - nu * lap[j][2]) for j in range(2))


def test_grad_advection_diffusion_transport_step() -> None:
    """A full implicit advection-diffusion step ``(I/dt + u d/dx - nu lap)
    x = b/dt`` (nonsymmetric): gradients w.r.t. the previous state equal
    JAX's and finite differences."""
    jm, jv, pm, pv = _fields(17, ("dirichlet",) * 4, name="c")
    nu, u, dt = 0.05, 1.0, 0.1
    jco = _transport_coeffs(jlaplacian_axis_coeffs(jm, jv.bcs),
                            jdiv_axis_coeffs(jm, jv.bcs, u, "none"), dt, nu)
    pco = _tcoeffs(_transport_coeffs(laplacian_axis_coeffs(pm, pv.bcs),
                                     div_axis_coeffs(pm, pv.bcs, u, "none"), dt, nu))
    jds = jadj.DifferentiableSolve(jm, jv.bcs, tol=1e-12)
    pds = DifferentiableSolve(pm, pv.bcs, tol=1e-12)
    c0 = np.random.default_rng(8).standard_normal((1, 17, 17))

    def step_loss(c):
        return torch.sum((pds(pco, c / dt) - 0.3) ** 2)

    assert _rel(pds(pco, _t(c0) / dt), jds(jco, jnp.asarray(c0) / dt)) < X_TOL
    g = _grad(step_loss, _t(c0))
    gj = jax.grad(lambda c: jnp.sum((jds(jco, c / dt) - 0.3) ** 2))(jnp.asarray(c0))
    assert _rel(g, gj) < G_TOL
    eps = 1e-6
    for idx in ((0, 8, 8), (0, 3, 12)):
        e = torch.zeros(1, 17, 17, dtype=F64)
        e[idx] = 1.0
        fd = (float(step_loss(_t(c0) + eps * e)) - float(step_loss(_t(c0) - eps * e))) / (2 * eps)
        assert_allclose(g[idx].item(), fd, rtol=2e-4, atol=5e-7)


class TestDifferentiableDiffusionSolve:
    """Gradients w.r.t. the PER-POINT coefficient field Γ, port against
    JAX, and the JAX tests' directional and recovery gates."""

    def _setup(self, bc_types, n=17):
        jm, jv, pm, pv = _fields(n, bc_types, name="t")
        return jm, jv, pm, pv

    def _check(self, jds, pds, gamma, rhs, seed=0):
        rng = np.random.default_rng(seed)
        target = rng.standard_normal(rhs.shape)
        v = rng.standard_normal(gamma.shape)
        tt = _t(target)

        def loss(g):
            return torch.sum((pds(g, _t(rhs)) - tt) ** 2)

        assert _rel(pds(_t(gamma), _t(rhs)), jds(jnp.asarray(gamma), jnp.asarray(rhs))) < X_TOL
        g = _grad(loss, _t(gamma))
        gj = jax.grad(lambda gm: jnp.sum((jds(gm, jnp.asarray(rhs)) - target) ** 2))(
            jnp.asarray(gamma))
        assert _rel(g, gj) < G_TOL
        eps = 1e-4
        fd = (float(loss(_t(gamma + eps * v))) - float(loss(_t(gamma - eps * v)))) / (2 * eps)
        ad = float(torch.sum(g * _t(v)))
        assert_allclose(ad, fd, rtol=2e-4, err_msg=f"ad={ad} fd={fd}")

    def test_grad_wrt_gamma_dirichlet(self):
        jm, jv, pm, pv = self._setup(["dirichlet"] * 4)
        X, Y = (np.asarray(g) for g in jm._grid_np)
        gamma = 1.0 + 0.5 * X + 0.3 * Y
        rhs = (np.sin(np.pi * X) * np.sin(np.pi * Y))[None]
        self._check(jadj.DifferentiableDiffusionSolve(jm, jv.bcs, tol=1e-12, symmetric=True),
                    DifferentiableDiffusionSolve(pm, pv.bcs, tol=1e-12, symmetric=True),
                    gamma, rhs)

    def test_grad_wrt_gamma_neumann_harmonic(self):
        """Neumann face (Γ-dependent nonsymmetric surgery, the hand
        transpose) + the nonlinear-in-Γ harmonic face rule."""
        jm, jv, pm, pv = self._setup(["neumann", "dirichlet", "dirichlet", "dirichlet"])
        X, Y = (np.asarray(g) for g in jm._grid_np)
        gamma = 1.5 + 0.4 * X * Y
        rhs = (np.cos(np.pi * X) * np.sin(np.pi * Y))[None]
        self._check(jadj.DifferentiableDiffusionSolve(jm, jv.bcs, tol=1e-12, avg="harmonic"),
                    DifferentiableDiffusionSolve(pm, pv.bcs, tol=1e-12, avg="harmonic"),
                    gamma, rhs, seed=1)

    def test_inversion_recovers_inclusion(self):
        """Recover a low-K inclusion from full-field pressure by Adam on
        log K (``torch.optim.Adam(lr=0.05)`` for ``optax.adam(0.05)``, the
        same defaults): misfit below 1e-3 of its start, K dips inside."""
        jm, jv, pm, pv = self._setup(["dirichlet"] * 4, n=17)
        X, Y = (np.asarray(g) for g in jm._grid_np)
        k_true = np.where((X - 0.5) ** 2 + (Y - 0.5) ** 2 < 0.15**2, 0.3, 1.0)
        rhs = np.ones_like(X)[None]
        jds = jadj.DifferentiableDiffusionSolve(jm, jv.bcs, tol=1e-10, symmetric=True)
        pds = DifferentiableDiffusionSolve(pm, pv.bcs, tol=1e-10, symmetric=True)
        p_obs = pds(_t(k_true), _t(rhs))
        assert _rel(p_obs, jds(jnp.asarray(k_true), jnp.asarray(rhs))) < X_TOL

        def loss(theta):
            return torch.sum((pds(torch.exp(theta), _t(rhs)) - p_obs) ** 2)

        gj = jax.grad(lambda th: jnp.sum((jds(jnp.exp(th), jnp.asarray(rhs))
                                          - jnp.asarray(p_obs.numpy())) ** 2))(
            jnp.zeros_like(jnp.asarray(k_true)))
        assert _rel(_grad(loss, torch.zeros(17, 17, dtype=F64)), gj) < G_TOL

        theta = torch.zeros(17, 17, dtype=F64, requires_grad=True)
        l0 = float(loss(theta.detach()))
        opt = torch.optim.Adam([theta], lr=0.05)
        for _ in range(150):
            opt.zero_grad()
            loss(theta).backward()
            opt.step()
        l1 = float(loss(theta.detach()))
        assert l1 < 1e-3 * l0, (l0, l1)
        k_rec = torch.exp(theta).detach().numpy()
        inside = (X - 0.5) ** 2 + (Y - 0.5) ** 2 < 0.12**2
        outside = (X - 0.5) ** 2 + (Y - 0.5) ** 2 > 0.25**2
        assert k_rec[inside].mean() < 0.7 * k_rec[outside & (X > 0) & (X < 1)].mean()


class TestDifferentiableTransient:
    """N implicit steps as one differentiable rollout: gradients w.r.t.
    the physical parameter, the initial condition and the per-point Γ,
    port against JAX and finite differences."""

    def _heat(self, n=17, dt=0.02, checkpoint=True):
        jm, jv, pm, pv = _fields(n, ("dirichlet",) * 4, name="T")
        jlap = jlaplacian_axis_coeffs(jm, jv.bcs)
        plap = _tcoeffs(laplacian_axis_coeffs(pm, pv.bcs))

        def jfn(nu):
            return tuple((-nu * ap, -nu * ac, -nu * am) for ap, ac, am in jlap)

        def pfn(nu):
            return tuple((-nu * ap, -nu * ac, -nu * am) for ap, ac, am in plap)

        jroll = jadj.DifferentiableTransient(jm, jv.bcs, jfn, dt=dt, tol=1e-12,
                                             checkpoint=checkpoint)
        proll = DifferentiableTransient(pm, pv.bcs, pfn, dt=dt, tol=1e-12,
                                        checkpoint=checkpoint)
        x0 = np.random.default_rng(3).standard_normal((1, n, n))
        X, Y = (np.asarray(g) for g in jm._grid_np)
        target = (np.sin(np.pi * X) * np.sin(np.pi * Y))[None]
        return jroll, proll, x0, target

    def test_grad_wrt_nu_vs_fd(self):
        jroll, proll, x0, target = self._heat()

        def loss(nu):
            return torch.sum((proll(nu, _t(x0), 5) - _t(target)) ** 2)

        nu0 = torch.tensor(0.05, dtype=F64)
        assert _rel(proll(nu0, _t(x0), 5), jroll(jnp.asarray(0.05), jnp.asarray(x0), 5)) < X_TOL
        g = _grad(loss, nu0).item()
        gj = float(jax.grad(lambda nu: jnp.sum((jroll(nu, jnp.asarray(x0), 5) - target) ** 2))(
            jnp.asarray(0.05)))
        assert abs(g - gj) <= G_TOL * abs(gj)
        eps = 1e-5
        fd = (float(loss(nu0 + eps)) - float(loss(nu0 - eps))) / (2 * eps)
        assert_allclose(g, fd, rtol=5e-5)

    def test_grad_wrt_initial_condition_vs_fd(self):
        jroll, proll, x0, target = self._heat()
        nu = torch.tensor(0.05, dtype=F64)

        def loss(x):
            return torch.sum((proll(nu, x, 4) - _t(target)) ** 2)

        g = _grad(loss, _t(x0))
        gj = jax.grad(lambda x: jnp.sum((jroll(jnp.asarray(0.05), x, 4) - target) ** 2))(
            jnp.asarray(x0))
        assert _rel(g, gj) < G_TOL
        eps = 1e-6
        for idx in ((0, 8, 8), (0, 4, 12)):
            e = torch.zeros(1, 17, 17, dtype=F64)
            e[idx] = 1.0
            fd = (float(loss(_t(x0) + eps * e)) - float(loss(_t(x0) - eps * e))) / (2 * eps)
            assert_allclose(g[idx].item(), fd, rtol=2e-4, atol=1e-8)

    def test_checkpoint_matches_stored_reverse(self):
        """Recomputing each step in the backward sweep changes memory, not
        values: gradients with and without it agree to 1e-12, and with
        JAX's."""
        _, roll_ck, x0, target = self._heat(checkpoint=True)
        jroll, roll_st, _, _ = self._heat(checkpoint=False)

        def loss_of(roll):
            return lambda nu: torch.sum((roll(nu, _t(x0), 4) - _t(target)) ** 2)

        nu0 = torch.tensor(0.07, dtype=F64)
        g_ck = _grad(loss_of(roll_ck), nu0).item()
        g_st = _grad(loss_of(roll_st), nu0).item()
        assert_allclose(g_ck, g_st, rtol=1e-12)
        gj = float(jax.grad(lambda nu: jnp.sum((jroll(nu, jnp.asarray(x0), 4) - target) ** 2))(
            jnp.asarray(0.07)))
        assert abs(g_ck - gj) <= G_TOL * abs(gj)

    def test_recover_nu_from_trajectory(self):
        """Recover the diffusivity from one observed endpoint by a secant
        iteration on the transient-adjoint gradient (within 1e-4)."""
        _, roll, x0, _ = self._heat()
        nu_true = 0.08
        obs = roll(torch.tensor(nu_true, dtype=F64), _t(x0), 5)

        def gfn(nu):
            return _grad(lambda v: torch.sum((roll(v, _t(x0), 5) - obs) ** 2),
                         torch.tensor(nu, dtype=F64)).item()

        nu0, nu1 = 0.02, 0.04
        g0 = gfn(nu0)
        for _ in range(12):
            g1 = gfn(nu1)
            if g1 == g0:
                break
            nu0, nu1, g0 = nu1, nu1 - g1 * (nu1 - nu0) / (g1 - g0), g1
            if abs(nu1 - nu0) < 1e-10:
                break
        assert abs(nu1 - nu_true) < 1e-4, nu1

    def test_transient_gamma_grad_vs_fd(self):
        """Per-point Γ through N steps (``DifferentiableTransientDiffusion``)
        against JAX and finite differences."""
        n, dt, n_steps = 13, 0.02, 3
        jm, jv, pm, pv = _fields(n, ("dirichlet",) * 4, name="T")
        jroll = jadj.DifferentiableTransientDiffusion(jm, jv.bcs, dt=dt, tol=1e-12)
        proll = DifferentiableTransientDiffusion(pm, pv.bcs, dt=dt, tol=1e-12)
        rng = np.random.default_rng(5)
        x0 = rng.standard_normal((1, n, n))
        gamma = 1.0 + 0.3 * rng.random((n, n))

        def loss(g):
            return torch.sum(proll(g, _t(x0), n_steps) ** 2)

        assert _rel(proll(_t(gamma), _t(x0), n_steps),
                    jroll(jnp.asarray(gamma), jnp.asarray(x0), n_steps)) < X_TOL
        grad = _grad(loss, _t(gamma))
        gj = jax.grad(lambda g: jnp.sum(jroll(g, jnp.asarray(x0), n_steps) ** 2))(
            jnp.asarray(gamma))
        assert _rel(grad, gj) < G_TOL
        eps = 1e-6
        for idx in ((6, 6), (3, 9)):
            e = torch.zeros(n, n, dtype=F64)
            e[idx] = 1.0
            fd = (float(loss(_t(gamma) + eps * e)) - float(loss(_t(gamma) - eps * e))) / (2 * eps)
            assert_allclose(grad[idx].item(), fd, rtol=5e-4, atol=1e-9)


# -- the hand-written helpers of the variable-Γ operator ---------------------

_SHAPES = [(1, 7, 9), (2, 5, 6, 7), (1, 3, 4, 3)]


def _surgeries(nd):
    for kinds in itertools.product(("none", "neumann"), repeat=2 * nd):
        yield tuple((kinds[2 * j], kinds[2 * j + 1]) for j in range(nd))


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("aniso", [False, True], ids=["iso", "stacked"])
@pytest.mark.parametrize("avg", ["arithmetic", "harmonic"])
def test_diff_field_helpers_match_vjp(shape, aniso, avg):
    """``diff_field_transpose`` and ``diff_field_gamma_vjp`` equal
    ``torch.func.vjp`` of the plain ``apply_diff_field`` and ``jax.vjp`` of
    the JAX package's, on every combination of Neumann faces (a 3-node
    axis with both faces among them), isotropic and stacked Γ, both face
    rules."""
    nd = len(shape) - 1
    nx = shape[1:]
    inv = tuple(float(i + 2) ** 2 for i in range(nd))
    rng = np.random.default_rng(sum(shape) + 7 * aniso + (avg == "harmonic"))
    for surgery in _surgeries(nd):
        g = 1.0 + rng.random((nd, *nx) if aniso else nx)
        x = rng.standard_normal(shape)
        y = rng.standard_normal(shape)
        _, vjp = torch.func.vjp(lambda xx, gg: apply_diff_field(xx, gg, inv, surgery, avg),
                                _t(x), _t(g))
        tx, tg = vjp(_t(y))
        _, jvjp = jax.vjp(lambda xx, gg: japply_diff_field(xx, gg, inv, surgery, avg=avg),
                          jnp.asarray(x), jnp.asarray(g))
        jx, jg = jvjp(jnp.asarray(y))
        trans = diff_field_transpose(_t(y), _t(g), inv, surgery, avg)
        gvjp = diff_field_gamma_vjp(_t(y), _t(x), _t(g), inv, surgery, avg)
        for got, want in ((trans, tx), (trans, jx), (gvjp, tg), (gvjp, jg)):
            assert _rel(got, want) <= HELPER_TOL, surgery


def test_cpu_gradient_counts_no_launch():
    """A gradient on the CPU takes the plain versions: neither the axis
    stencil nor the variable-Γ wrapper counts a launch."""
    (_, _, _, _), (pm, pv, pc, pds), rhs = _setup(n=9)
    a0, d0 = axis_mod.axis_stencil.launches, diff_mod.diff_field.launches
    _grad(lambda b: torch.sum(pds(pc, b) ** 2), _t(rhs[:, :9, :9]))
    dds = DifferentiableDiffusionSolve(pm, pv.bcs, tol=1e-10)
    _grad(lambda g: torch.sum(dds(g, _t(rhs[:, :9, :9])) ** 2), torch.ones(9, 9, dtype=F64))
    assert dds.itr["forward"] > 0 and dds.itr["adjoint"] > 0
    assert (axis_mod.axis_stencil.launches, diff_mod.diff_field.launches) == (a0, d0)


def test_transient_rejects_bad_bcs():
    """The diffusion classes reject periodic faces and rz meshes; every
    class rejects inhomogeneous values."""
    from pyapes_tpu_torch.geometry import Cylinder

    _, pm = _meshes(9)
    per = Field("T", 1, pm, {"domain": mixed_bcs([0.0] * 4, ["periodic", "periodic",
                                                             "dirichlet", "dirichlet"]),
                             "obstacle": None})
    with pytest.raises(ValueError, match="unsupported BC"):
        DifferentiableTransientDiffusion(pm, per.bcs, dt=0.1)
    DifferentiableTransient(pm, per.bcs, lambda t: t, dt=0.1)  # periodic axes: fine
    rz = Mesh(Cylinder[0:1, 0:1], None, [9, 9], device="cpu", dtype="double")
    with pytest.raises(ValueError, match="rz"):
        DifferentiableDiffusionSolve(rz, [])
    hot = Field("T", 1, pm, {"domain": mixed_bcs([0.0, 2.0, 0.0, 0.0], ["dirichlet"] * 4),
                             "obstacle": None})
    with pytest.raises(ValueError, match="homogeneous"):
        DifferentiableTransientDiffusion(pm, hot.bcs, dt=0.1)
