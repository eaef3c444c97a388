"""The explicit-operator slice against the JAX package (CPU, float64):
``FDC`` Grad, Laplacian and Div (central, upwind and QUICK; constant,
array, ``Field``, ``Jac`` and ``Hess`` advectors; conservative and
advective forms) with ``edge`` True and False on Dirichlet, Neumann,
Symmetry and periodic faces in 1-, 2- and 3-D; ``jacobian``, ``hessian``,
``DiffFlux``; ``fdm.grad`` in an assembled equation and in a solve; and
the goldens and oracles the JAX tests hold the JAX package to
(``tests/data/parity_golden.npz``, ``tests/test_fdm.py``).

Tolerance: the same numpy inputs from a seed, the same arithmetic in both
packages (roll sums in the same term order), so every output agrees within
1e-12 relative to its largest magnitude (or 1e-12 absolute below 1).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.solver import fdc as jfdc  # noqa: E402
from pyapes_tpu.solver.fdm import FDM as JFDM  # noqa: E402
from pyapes_tpu.solver.ops import Solver as JSolver  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu.variables.bcs import homogeneous_bcs as jhomogeneous  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops.stencil import grad_axis_coeffs  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.solver.fdc import FDC, AxisCoeffs, DiffFlux, hessian, jacobian  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import homogeneous_bcs  # noqa: E402
from pyapes_tpu_torch.variables.container import Hess, Jac  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = ["xl", "xu", "yl", "yu", "zl", "zu"]
TOL = 1e-12


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float64)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol * max(1.0, np.abs(a).max()), err


# face kinds per axis (lower, upper); the values of Dirichlet and Neumann
# faces are nonzero so the RHS corrections carry weight
BCS = {
    "dirichlet": ("dirichlet",) * 6,
    "neumann": ("neumann",) * 6,
    "symmetry": ("symmetry",) * 6,
    "periodic": ("periodic",) * 6,
    "mixed": ("neumann", "dirichlet", "periodic", "periodic", "symmetry", "neumann"),
}


def _bcs(kinds, dim):
    return [{"bc_face": f, "bc_type": k,
             "bc_val": None if k in ("periodic", "symmetry") else 0.3 * (i + 1),
             "bc_val_opt": None}
            for i, (f, k) in enumerate(zip(FACES[: 2 * dim], kinds))]


def _pair(dim, bc_name, vdim, seed, nx=(7, 8, 9)):
    """The same random field in both packages: ``(jax Field, port Field)``."""
    nx = list(nx[:dim])
    box = tuple(slice(0, 1) for _ in range(dim))
    jm = JMesh(JBox[box], None, nx, dtype="double")
    pm = Mesh(Box[box], None, nx, device="cpu", dtype="double")
    f = np.random.default_rng(seed).standard_normal((vdim, *nx))
    cfg = None if bc_name is None else _bcs(BCS[bc_name], dim)
    jf = JField("t", vdim, jm, None if cfg is None else {"domain": cfg, "obstacle": None})
    pf = Field("t", vdim, pm, None if cfg is None else {"domain": cfg, "obstacle": None})
    jf.set_var_tensor(jnp.asarray(f))
    pf.set_var_tensor(torch.as_tensor(f))
    return jf, pf


def _vdims(dim):
    return sorted({1, dim})


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("bc_name", sorted(BCS))
@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("op", ["grad", "laplacian"])
def test_grad_laplacian_match_jax(op, dim, bc_name, edge):
    for vdim in _vdims(dim):
        jf, pf = _pair(dim, bc_name, vdim, seed=dim + vdim)
        jop, pop = getattr(jfdc.FDC(), op), getattr(FDC(), op)
        _close(jop(jf, edge=edge), pop(pf, edge=edge))
        # the Neumann RHS correction the implicit operator folds in
        _close(jop.rhs_adj, pop.rhs_adj)


def _advectors(kind, vdim, jf, pf, seed):
    if kind == "const":
        return -0.7, -0.7
    a = np.random.default_rng(seed).standard_normal(pf().shape)
    if kind == "array":
        return jnp.asarray(a), torch.as_tensor(a)
    ja = JField("a", vdim, jf.mesh, None)
    pa = Field("a", vdim, pf.mesh, None)
    ja.set_var_tensor(jnp.asarray(a))
    pa.set_var_tensor(torch.as_tensor(a))
    return ja, pa


@pytest.mark.parametrize("form", ["conservative", "advective"])
@pytest.mark.parametrize("adv", ["const", "array", "field"])
@pytest.mark.parametrize("limiter", ["none", "upwind", "quick"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_div_matches_jax(dim, limiter, adv, form):
    """Every face set, both edge modes and scalar and vector targets."""
    for bc_name in sorted(BCS):
        for vdim in _vdims(dim):
            jf, pf = _pair(dim, bc_name, vdim, seed=10 * dim + vdim)
            ja, pa = _advectors(adv, vdim, jf, pf, seed=dim)
            for edge in (False, True):
                cfg = {"div": {"limiter": limiter, "form": form, "edge": edge}}
                jop, pop = jfdc.FDC(cfg).div, FDC(cfg).div
                _close(jop(ja, jf), pop(pa, pf))
                _close(jop.rhs_adj, pop.rhs_adj)


@pytest.mark.parametrize("limiter", ["none", "upwind", "quick"])
@pytest.mark.parametrize("kind", ["jac", "hess"])
def test_div_with_derivative_advectors_matches_jax(kind, limiter):
    """A ``Jac`` (the flux per mesh axis) or ``Hess`` (the tensor entry per
    component and axis) as the advector, on a scalar and a vector target."""
    for vdim in (1, 2):
        for bc_name in ("dirichlet", "mixed"):
            jf, pf = _pair(2, bc_name, vdim, seed=vdim)
            jh, ph = _pair(2, None, 1, seed=7)
            if kind == "jac":
                ja, pa = jfdc.jacobian(jh), jacobian(ph)
            else:
                ja, pa = jfdc.hessian(jh), hessian(ph)
            for edge in (False, True):
                cfg = {"div": {"limiter": limiter, "edge": edge}}
                _close(jfdc.FDC(cfg).div(ja, jf), FDC(cfg).div(pa, pf))


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_jacobian_hessian_diffflux_match_jax(dim):
    jf, pf = _pair(dim, None, 1, seed=3 * dim, nx=(9, 11, 6))
    jj, pj = jfdc.jacobian(jf), jacobian(pf)
    assert isinstance(pj, Jac) and pj.keys == jj.keys
    for k in jj.keys:
        _close(getattr(jj, k), getattr(pj, k))
    jh, ph = jfdc.hessian(jf), hessian(pf)
    assert isinstance(ph, Hess) and ph.keys == jh.keys
    for k in jh.keys:
        _close(getattr(jh, k), getattr(ph, k))
    # DiffFlux of the field's own Hessian as the diffusion tensor
    jflux, pflux = jfdc.DiffFlux()(jh, jf), DiffFlux()(ph, pf)
    assert pflux.dim == dim and pflux.bcs == []
    _close(jflux(), pflux())
    # through the facade, as its users call it
    _close(jfdc.FDC().diffFlux(jh, jf)(), FDC().diffFlux(ph, pf)())


def test_field_without_bcs_is_the_jax_rule():
    """``DiffFlux`` builds its flux with ``bc_config=None``: in both packages
    such a Field has no BCs and keeps its values through ``apply_bcs``; a
    dict without ``"domain"`` raises in both."""
    mesh = Mesh(Box[0:1, 0:1], None, [5, 6], device="cpu", dtype="double")
    jmesh = JMesh(JBox[0:1, 0:1], None, [5, 6], dtype="double")
    f = Field("f", 2, mesh, None, init_val=0.5)
    assert f.bcs == [] and JField("f", 2, jmesh, None).bcs == []
    before = f().clone()
    assert torch.equal(f.apply_bcs()(), before)
    with pytest.raises(ValueError, match="domain must be defined"):
        Field("f", 1, mesh, {"obstacle": None})
    with pytest.raises(ValueError, match="domain must be defined"):
        JField("f", 1, jmesh, {"obstacle": None})


def _golden():
    return np.load(os.path.join(REPO, "tests", "data", "parity_golden.npz"))


def test_goldens_grad_and_laplacian():
    """The reference's explicit Grad (Dirichlet) and Laplacian (Neumann)
    on the interior, the JAX tests' goldens and tolerances."""
    g = _golden()
    f = np.random.default_rng(3).standard_normal((11, 13))
    mesh = Mesh(Box[0:1, 0:1.2], None, [11, 13], device="cpu", dtype="double")
    var = Field("t", 1, mesh, {"domain": homogeneous_bcs(2, 0.5, "dirichlet"), "obstacle": None})
    var.set_var_tensor(torch.as_tensor(f[None]))
    grad = FDC({"grad": {"edge": False}}).grad(var)
    np.testing.assert_allclose(grad[0].numpy()[:, 1:-1, 1:-1],
                               g["grad_dirichlet"][:, 1:-1, 1:-1], atol=1e-12)

    f = np.random.default_rng(0).standard_normal((9, 9))
    mesh = Mesh(Box[0:1, 0:1], None, [9, 9], device="cpu", dtype="double")
    var = Field("t", 1, mesh, {"domain": homogeneous_bcs(2, 2.0, "neumann"), "obstacle": None})
    var.set_var_tensor(torch.as_tensor(f[None]))
    lap = FDC({"laplacian": {"edge": False}}).laplacian(var)
    np.testing.assert_allclose(lap[0].numpy()[1:-1, 1:-1], g["lap_neumann"][1:-1, 1:-1],
                               atol=1e-11)


def test_goldens_jacobian_hessian():
    """The reference's bank-free derivative stack (its golden is on an rz
    mesh; the derivatives read only the spacing, so a Box of the same
    nodes reproduces it)."""
    g = _golden()
    mesh = Mesh(Box[0:2, -2:2], None, [17, 25], device="cpu", dtype="double")
    R, Z = mesh.X.numpy(), mesh.Y.numpy()
    var = Field("h", 1, mesh, None)
    var.set_var_tensor(torch.as_tensor(np.exp(-(R**2 + Z**2) / 2.0)[None]))
    jac, hess = jacobian(var), hessian(var)
    np.testing.assert_allclose(jac.x.numpy(), g["jh_jac_r"], atol=1e-12)
    np.testing.assert_allclose(jac.y.numpy(), g["jh_jac_z"], atol=1e-12)
    for ours, ref in (("xx", "rr"), ("xy", "rz"), ("yy", "zz")):
        np.testing.assert_allclose(hess[ours].numpy(), g[f"jh_hess_{ref}"], atol=1e-12)

    mesh = Mesh(Box[0:2, -2:2], None, [33, 33], device="cpu", dtype="double")
    R, Z = mesh.X.numpy(), mesh.Y.numpy()
    hp = Field("H", 1, mesh, None)
    hp.set_var_tensor(torch.as_tensor((np.cos(R) * np.exp(-(Z**2) / 2))[None]))
    jacH = jacobian(hp)
    np.testing.assert_allclose(jacH.x.numpy(), g["rfp_jac_r"], atol=1e-12)
    np.testing.assert_allclose(jacH.y.numpy(), g["rfp_jac_z"], atol=1e-12)


def test_edge_oracle_numpy_gradient():
    """Edge-mode grad/laplacian against ``numpy.gradient(edge_order=2)``
    (``tests/test_fdm.py:33-55``)."""
    mesh = Mesh(Box[0:1, 0:1], None, [5, 5], device="cpu", dtype="double")
    var = Field("test", 1, mesh, {"domain": None, "obstacle": None})
    var <<= 0.3 * mesh.X**2
    fdc = FDC()
    v = var()[0].numpy()
    dx = float(mesh.dx_np[0])
    grad_np = np.gradient(v, dx, edge_order=2)
    np.testing.assert_allclose(fdc.grad(var, edge=True)[0][0].numpy(), grad_np[0], atol=1e-12)
    lap_np = (np.gradient(grad_np[0], dx, edge_order=2)[0]
              + np.gradient(grad_np[1], dx, edge_order=2)[1])
    np.testing.assert_allclose(fdc.laplacian(var, edge=True)[0].numpy(), lap_np, atol=1e-12)


def _grad_manuel_op(var, dx, dim):
    """The x-gradient with the Neumann elimination rows
    (``tests/test_fdm.py:103-130``)."""
    grad = (np.roll(var, -1, 0) - np.roll(var, 1, 0)) / (2 * dx)
    x_inner = grad.copy()
    x_inner[1] = (4 / 3 * var[2] - 4 / 3 * var[1]) / (2 * dx)
    x_inner[-2] = (4 / 3 * var[-2] - 4 / 3 * var[-3]) / (2 * dx)
    if dim == 1:
        return x_inner
    for ax in range(dim):
        for row in (1, -2):
            sel = (slice(None),) * ax + (row,)
            grad[sel] = x_inner[sel]
    return grad


def _lap_manuel_op(var, dx, dim):
    """The Laplacian with the Neumann elimination rows
    (``tests/test_fdm.py:133-158``)."""
    lap = sum((np.roll(var, -1, i) - 2 * var + np.roll(var, 1, i)) / dx**2 for i in range(dim))
    x_inner = (np.roll(var, -1, 0) - 2 * var + np.roll(var, 1, 0)) / dx**2
    x_inner[1] = (2 / 3 * var[2] - 2 / 3 * var[1]) / dx**2
    x_inner[-2] = (-2 / 3 * var[-2] + 2 / 3 * var[-3]) / dx**2
    if dim == 1:
        return x_inner
    for ax in range(dim):
        for row in (1, -2):
            sel = (slice(None),) * ax + (row,)
            lap[sel] = x_inner[sel]
    return lap


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_neumann_oracles(dim):
    """Grad and Laplacian with Neumann faces against the hand-built
    elimination rows (``tests/test_fdm.py:58-100``), and the one-sided
    boundary gradient equal to the outward flux."""
    box = tuple(slice(0, 1) for _ in range(dim))
    mesh = Mesh(Box[box], None, [0.2] * dim, device="cpu", dtype="double")
    inner = (slice(1, -1),) * dim
    var = Field("test", 1, mesh, {"domain": homogeneous_bcs(dim, 2.0, "neumann"),
                                  "obstacle": None})
    var <<= 0.3 * mesh.X**2
    var.apply_bcs()
    v = var()[0].numpy()
    dx = float(mesh.dx_np[0])
    np.testing.assert_allclose(((-1.5 * v[0] + 2 * v[1] - 0.5 * v[2]) / dx).mean(), -2.0,
                               atol=1e-12)
    np.testing.assert_allclose(((1.5 * v[-1] - 2 * v[-2] + 0.5 * v[-3]) / dx).mean(), 2.0,
                               atol=1e-12)
    fdc = FDC()
    lap = fdc.laplacian(var, edge=False)
    np.testing.assert_allclose(lap[0].numpy()[inner], _lap_manuel_op(v, dx, dim)[inner],
                               atol=1e-12)
    assert isinstance(fdc.laplacian.A_coeffs, AxisCoeffs)
    fdc.laplacian.reset()
    assert fdc.laplacian.A_coeffs is None and fdc.laplacian.rhs_adj is None
    grad = fdc.grad(var, edge=False)
    np.testing.assert_allclose(grad[0][0].numpy()[inner], _grad_manuel_op(v, dx, dim)[inner],
                               atol=1e-12)


def test_grad_axis_coeffs_match_jax():
    from pyapes_tpu.ops.stencil import grad_axis_coeffs as jgrad_axis_coeffs

    jf, pf = _pair(3, "mixed", 1, seed=0)
    for ja, pa in zip(jgrad_axis_coeffs(jf.mesh, jf.bcs), grad_axis_coeffs(pf.mesh, pf.bcs)):
        for jc, pc in zip(ja, pa):
            assert np.array_equal(np.asarray(jc), pc)


def test_explicit_vectors_are_kept_on_the_device():
    """An operator object builds and uploads its per-axis vectors once per
    (grid, BC kinds, constant advection and config, dtype, device): a
    second call reuses them; another BC kind or advection builds its own;
    per-point banks are rebuilt on every call."""
    _, pf = _pair(2, "neumann", 1, seed=0)
    _, pd = _pair(2, "dirichlet", 1, seed=0)
    fdc = FDC({"div": {"limiter": "upwind"}})
    fdc.grad(pf, edge=True)
    first = fdc.grad.A_coeffs
    fdc.grad(pf, edge=True)
    assert fdc.grad.A_coeffs is first and len(fdc.grad._vec_cache) == 1
    fdc.grad(pd, edge=True)
    assert fdc.grad.A_coeffs is not first and len(fdc.grad._vec_cache) == 2
    assert all(isinstance(c, torch.Tensor) for cs in first.vecs for c in cs)
    for adv in (2.0, 2.0, -1.0):
        fdc.div(adv, pf)
    assert len(fdc.div._vec_cache) == 2
    fdc.div(torch.ones_like(pf()), pf)
    assert not isinstance(fdc.div.A_coeffs, AxisCoeffs) and len(fdc.div._vec_cache) == 2


def test_fdm_grad_assembled_operator_matches_jax():
    """``fdm.grad`` in an equation: the summed central gradient (the
    ``tests/test_fdm.py:213-221`` oracle in 1-D) and the JAX package's
    ``Aop`` in 2-D with Neumann faces, a coefficient and its RHS
    correction."""
    mesh = Mesh(Box[0:1], None, [0.2], device="cpu", dtype="double")
    var = Field("t", 1, mesh, None)
    var.set_var_tensor(2 * mesh.X**2)
    v = var()[0].numpy()
    dx = float(mesh.dx_np[0])
    fdm, solver = FDM(), Solver(None)
    solver.set_eq(fdm.grad(var) - fdm.laplacian(3.0, var) == 2.0)
    t_grad = (np.roll(v, -1, 0) - np.roll(v, 1, 0)) / (2 * dx)
    t_lap = (np.roll(v, -1, 0) - 2 * v + np.roll(v, 1, 0)) / dx**2 * 3.0
    np.testing.assert_allclose(solver.Aop(var)[0].numpy()[1:-1], (t_grad - t_lap)[1:-1],
                               atol=1e-12)

    jf, pf = _pair(2, "neumann", 1, seed=4)
    jsolver, psolver = JSolver(None), Solver(None)
    jsolver.set_eq(JFDM().grad(0.5, jf) - JFDM().laplacian(1.0, jf) == 1.0)
    psolver.set_eq(FDM().grad(0.5, pf) - FDM().laplacian(1.0, pf) == 1.0)
    _close(jsolver.Aop(jf), psolver.Aop(pf))
    _close(jsolver.rhs, psolver.rhs)


@pytest.mark.parametrize("method", ["bicgstab", "fastdiag"])
def test_fdm_grad_solve_matches_jax(method):
    """The 1-D advection-diffusion solve ``grad(u) - eps lap(u) = 1``
    (``tests/test_solver.py:330-354``) in both packages: the same
    iterations, the solutions within the solve's tolerance (the operator
    and RHS agree to 1e-12 above; 60 BiCGSTAB iterations on this
    nonsymmetric system carry the round-off of the two summation orders
    to well below it), and the exact solution within the JAX test's bounds.
    ``fastdiag`` with ``fd_fallback``: the antisymmetric grad term is not
    separable, so both resolve to BiCGSTAB."""
    from math import exp

    cfg = {"method": method, "tol": 1e-5, "max_it": 1000, "report": False}
    if method == "fastdiag":
        cfg["fd_fallback"] = "bicgstab"
    jm = JMesh(JBox[0:1], None, [0.05], dtype="double")
    pm = Mesh(Box[0:1], None, [0.05], device="cpu", dtype="double")
    jv = JField("U", 1, jm, {"domain": jhomogeneous(1, 0.0, "dirichlet"), "obstacle": None},
                init_val=0.5)
    pv = Field("U", 1, pm, {"domain": homogeneous_bcs(1, 0.0, "dirichlet"), "obstacle": None},
               init_val=0.5)
    js, ps = JSolver({"fdm": dict(cfg)}), Solver({"fdm": dict(cfg)})
    eps = 0.5
    js.set_eq(JFDM().grad(jv) - JFDM().laplacian(eps, jv) == 1.0)
    ps.set_eq(FDM().grad(pv) - FDM().laplacian(eps, pv) == 1.0)
    jr, pr = js.solve(), ps.solve()
    assert pr["itr"] == jr["itr"] and pr["converge"]
    _close(jv(), pv(), tol=cfg["tol"])
    x = pm.X.numpy()
    sol_ex = x - (np.exp(-(1 - x) / eps) - exp(-1 / eps)) / (1 - exp(-1 / eps))
    np.testing.assert_allclose(pv()[0].numpy(), sol_ex, rtol=0.1, atol=0.01)
