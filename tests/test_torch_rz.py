"""The axisymmetric (rz) path of the port against the JAX package (CPU,
float64): the Cylinder mesh, ``CylinderBoundary`` and BC application, the
rz volume integral, the rz coefficient vectors and FDC terms (1e-12), the
checked-in goldens of the original torch reference (``poisson_rz`` 1e-6,
the jacobian / hessian stack 1e-12), the 2-D axis stencil on rz vectors
against the JAX Pallas kernel in interpret mode, fastdiag on rz, and
MG-BiCGSTAB on rz (the same iterations, the same level vectors, within
the tolerance)."""
from math import cos, exp

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.geometry import Cylinder as JCylinder  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.ops import stencil as jstencil  # noqa: E402
from pyapes_tpu.ops.pallas_stencil import pallas_axis_stencil  # noqa: E402
from pyapes_tpu.solver import fdc as jfdc  # noqa: E402
from pyapes_tpu.solver.fdm import FDM as JFDM  # noqa: E402
from pyapes_tpu.solver.multigrid import MGSpec as JMGSpec  # noqa: E402
from pyapes_tpu.solver.ops import Solver as JSolver  # noqa: E402
from pyapes_tpu.solver.tools import default_A_ops as jdefault_A_ops  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu.variables.bcs import CylinderBoundary as JCylinderBoundary  # noqa: E402
from pyapes_tpu.variables.container import Hess as JHess, Jac as JJac  # noqa: E402
from pyapes_tpu_torch.geometry import Box, Cylinder  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.models import PoissonSolver  # noqa: E402
from pyapes_tpu_torch.ops import stencil as pstencil  # noqa: E402
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.solver import fdc as pfdc  # noqa: E402
from pyapes_tpu_torch.solver.multigrid import MGSpec  # noqa: E402
from pyapes_tpu_torch.solver.tools import default_A_ops  # noqa: E402
from pyapes_tpu_torch.utils.carry import coeffs_from_numpy  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import CylinderBoundary  # noqa: E402
from pyapes_tpu_torch.variables.container import Hess, Jac  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

TOL = 1e-12  # relative, float64: operators and vectors


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _meshes(bounds, nx):
    (r0, r1), (z0, z1) = bounds
    return (JMesh(JCylinder[r0:r1, z0:z1], None, list(nx), dtype="double"),
            Mesh(Cylinder[r0:r1, z0:z1], None, list(nx), device="cpu", dtype="double"))


# per-face (type, value) of the BC sets on the rz faces; "call" values are
# full-grid callables in each package's array library
BC_SETS = {
    "sym_dir": {"rl": ("symmetry", None), "ru": ("dirichlet", 0.3),
                "zl": ("dirichlet", "call"), "zu": ("dirichlet", -0.2)},
    "neu_mixed": {"rl": ("neumann", 0.0), "ru": ("neumann", 0.7),
                  "zl": ("neumann", 1.3), "zu": ("dirichlet", 0.44)},
    "dir_all": {"rl": ("dirichlet", 1.0), "ru": ("dirichlet", "call"),
                "zl": ("dirichlet", 0.0), "zu": ("dirichlet", 0.5)},
}


def _bcs(spec, lib):
    def val(v):
        if v != "call":
            return v
        if lib is jnp:
            return lambda g, m, var, o: jnp.exp(-g[1]) * jnp.cos(g[0])
        return lambda g, m, var, o: torch.exp(-g[1]) * torch.cos(g[0])

    cls = JCylinderBoundary if lib is jnp else CylinderBoundary
    return cls(**{f: {"bc_type": t, "bc_val": val(v)} for f, (t, v) in spec.items()})()


def _fields(spec, bounds=((0, 1), (0, 2)), nx=(9, 13), seed=3):
    jm, pm = _meshes(bounds, nx)
    x = np.random.default_rng(seed).standard_normal((1, *nx))
    jf = JField("v", 1, jm, {"domain": _bcs(spec, jnp), "obstacle": None})
    pf = Field("v", 1, pm, {"domain": _bcs(spec, torch), "obstacle": None})
    jf.set_var_tensor(jnp.asarray(x))
    pf.set_var_tensor(x)
    return jf, pf


# -- mesh, BCs, volume integral -------------------------------------------
def test_mesh_rz_matches_jax():
    jm, pm = _meshes(((0, 1), (0, 2)), (5, 7))
    assert pm.coord_sys == "rz" and pm.dim == 2 and pm.nx == jm.nx
    assert set(pm.d_mask) == {"rl", "ru", "zl", "zu"}
    for face in pm.d_mask:
        assert np.array_equal(pm.d_mask[face], jm.d_mask[face])
        assert pm.d_mask_dim(face) == jm.d_mask_dim(face)
        assert np.array_equal(pm.d_mask_shift(face, 1), jm.d_mask_shift(face, 1))
    assert np.array_equal(pm.t_mask, jm.t_mask)
    _close(pm.R, jm.R, 0.0)
    _close(pm.Z, jm.Z, 0.0)
    assert pm.Y.numel() == 0 and pm.R.device.type == "cpu"
    for a, b in zip(pm._x_np, jm._x_np):
        assert np.array_equal(a, b)
    for a, b in zip(pm._grid_np, jm._grid_np):
        assert np.array_equal(a, b)
    _close(pm.dx, jm.dx, 0.0)
    for a, b in zip(pm.dg, jm.dg):
        _close(a, b, 0.0)
    with pytest.raises(KeyError):
        Mesh(Box[0:1, 0:1], None, [5, 5], device="cpu").R


def test_mesh_rz_requires_2d():
    with pytest.raises(AssertionError):
        Cylinder[0:1, 0:1, 0:1]


def test_cylinder_boundary_config_matches_jax():
    spec = {"rl": {"bc_type": "dirichlet", "bc_val": 0.44},
            "ru": {"bc_type": "neumann", "bc_val": 0},
            "zl": {"bc_type": "periodic", "bc_val": None},
            "zu": {"bc_type": "symmetry", "bc_val": None, "bc_val_opt": {"k": 1}}}
    assert CylinderBoundary(**spec)() == JCylinderBoundary(**spec)()


@pytest.mark.parametrize("name", sorted(BC_SETS))
def test_cylinder_bc_application_matches_jax(name):
    jf, pf = _fields(BC_SETS[name])
    assert [b.bc_face_dim for b in pf.bcs] == [b.bc_face_dim for b in jf.bcs]
    assert [b.bc_n_dir for b in pf.bcs] == [b.bc_n_dir for b in jf.bcs]
    for jb, pb in zip(jf.bcs, pf.bcs):
        assert pb.dx_face == jb.dx_face
    _close(pf.apply_bcs()(), jf.apply_bcs()(), 1e-15)


def test_cylinder_bc_callable_with_options():
    """The JAX test's callable payloads (``bc_val_opt``) on the rz faces."""
    def zu_bc(grid, mask, _, opt):
        return grid[0] * torch.sum(opt["T"])

    mesh = Mesh(Cylinder[0:1, 0:2], None, [5, 5], device="cpu", dtype="double")
    f_bc = CylinderBoundary(
        rl={"bc_type": "neumann", "bc_val": 0},
        ru={"bc_type": "dirichlet", "bc_val": lambda g, m, *_: g[1] * 4.4},
        zl={"bc_type": "neumann", "bc_val": 1.3},
        zu={"bc_type": "dirichlet", "bc_val": zu_bc,
            "bc_val_opt": {"T": torch.ones(5, 5, dtype=torch.float64)}},
    )
    var = Field("d", 1, mesh, {"domain": f_bc(), "obstacle": None}, init_val="random")
    v = var.apply_bcs()()[0].numpy()
    assert np.allclose(v[-1, 1:-1], 4.4 * mesh._grid_np[1][0][1:-1])
    assert np.allclose(v[0, 1:-1], 4 / 3 * v[1, 1:-1] - 1 / 3 * v[2, 1:-1])
    assert np.allclose(v[1:-1, 0], 4 / 3 * v[1:-1, 1] - 1 / 3 * v[1:-1, 2] + 2 / 3 * 1.3 * 0.5)
    assert np.allclose(v[1:-1, -1], mesh._grid_np[0][1:-1, -1] * 25)


@pytest.mark.parametrize("bounds", [((0, 1), (0, 2)), ((0.5, 2), (-1, 1))])
def test_volume_integral_rz_matches_jax(bounds):
    jm, pm = _meshes(bounds, (11, 17))
    x = np.random.default_rng(4).random((2, 11, 17))
    jf = JField("v", 2, jm, None)
    jf.set_var_tensor(jnp.asarray(x))
    pf = Field("v", 2, pm, None).set_var_tensor(x)
    _close(pf.volume_integral(), jf.volume_integral())


# -- coefficient vectors, FDC terms ---------------------------------------
@pytest.mark.parametrize("name", sorted(BC_SETS))
def test_rz_axis_coefficients_match_jax(name):
    """The rz Laplacian / Div / Grad vectors carry the radial terms and are
    bit-equal to the JAX package's (the same numpy code), the r = 0 row of
    ``nan_to_num(dr / (2 r))`` included."""
    jf, pf = _fields(BC_SETS[name])
    pairs = [(pstencil.laplacian_axis_coeffs(pf.mesh, pf.bcs),
              jstencil.laplacian_axis_coeffs(jf.mesh, jf.bcs)),
             (pstencil.grad_axis_coeffs(pf.mesh, pf.bcs, 0.7),
              jstencil.grad_axis_coeffs(jf.mesh, jf.bcs, 0.7))]
    for lim in ("none", "upwind", "quick"):
        for g in (1.3, -0.6):
            pairs.append((pstencil.div_axis_coeffs(pf.mesh, pf.bcs, g, lim),
                          jstencil.div_axis_coeffs(jf.mesh, jf.bcs, g, lim)))
    for got, want in pairs:
        for cs_p, cs_j in zip(got, want):
            for a, b in zip(cs_p, cs_j):
                assert np.array_equal(np.asarray(a), np.asarray(b))
    # radial Laplacian at r = 0 (no symmetry surgery there): the scale is 0
    ap, ac, am = pstencil.laplacian_axis_coeffs(pf.mesh, None)[0]
    assert ap[0] == am[0] == 1.0 / float(pf.mesh.dx_np[0]) ** 2
    assert np.all(ap[1:] > am[1:])


@pytest.mark.parametrize("op", ["div", "laplacian", "grad"])
def test_default_A_ops_rz_match_jax(op):
    jf, pf = _fields(BC_SETS["dir_all"])
    for bp, bj in zip(default_A_ops(pf, op), jdefault_A_ops(jf, op)):
        for a, b in zip(bp, bj):
            _close(a, b, 0.0)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("name", sorted(BC_SETS))
def test_fdc_laplacian_rz_matches_jax(name, edge):
    """The explicit rz Laplacian and its Neumann RHS rows (the eliminated
    ``1 -+ dr/(2r)`` bank value, nonzero fluxes on both radial faces)."""
    jf, pf = _fields(BC_SETS[name])
    jl, pl = jfdc.FDC({"laplacian": {"edge": edge}}).laplacian, pfdc.FDC(
        {"laplacian": {"edge": edge}}).laplacian
    _close(pl(pf), jl(jf))
    _close(pl.rhs_adj, jl.rhs_adj)


def _advectors(pm, jm, kind, seed=8):
    rng = np.random.default_rng(seed)
    if kind == "float":
        return 0.8, 0.8
    if kind == "field":
        a = rng.standard_normal((1, *pm.nx))
        return Field("a", 1, pm, None).set_var_tensor(a), (lambda f: (
            f.set_var_tensor(jnp.asarray(a)), f)[1])(JField("a", 1, jm, None))
    comps = {k: rng.standard_normal(pm.nx) for k in (("r", "z") if kind == "jac" else
                                                     ("rr", "rz", "zz"))}
    if kind == "jac":
        return (Jac(**{k: torch.from_numpy(v) for k, v in comps.items()}),
                JJac(**{k: jnp.asarray(v) for k, v in comps.items()}))
    return (Hess(**{k: torch.from_numpy(v) for k, v in comps.items()}),
            JHess(**{k: jnp.asarray(v) for k, v in comps.items()}))


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("limiter", ["none", "upwind", "quick"])
@pytest.mark.parametrize("kind", ["float", "field", "jac", "hess"])
def test_fdc_div_rz_matches_jax(kind, limiter, edge):
    """The explicit rz Div: the ``2 dr / r`` centre term of the banks (the
    QUICK / upwind ``ac_base`` included) and the one-sided edge rows'
    ``adv phi / r`` term; the RHS rows of the Neumann faces."""
    jf, pf = _fields(BC_SETS["neu_mixed"])
    ap, aj = _advectors(pf.mesh, jf.mesh, kind)
    cfg = {"div": {"limiter": limiter, "edge": edge}}
    jd, pd = jfdc.FDC(cfg).div, pfdc.FDC(cfg).div
    _close(pd(ap, pf), jd(aj, jf))
    _close(pd.rhs_adj, jd.rhs_adj)


def test_diff_flux_and_derivatives_rz_match_jax():
    jf, pf = _fields(BC_SETS["dir_all"], bounds=((0, 2), (-2, 2)), nx=(17, 25))
    _, hp_j = _advectors(pf.mesh, jf.mesh, "hess")
    hp = Hess(**{k: torch.tensor(np.asarray(getattr(hp_j, k))) for k in ("rr", "rz", "zz")})
    _close(pfdc.FDC().diffFlux(hp, pf)(), jfdc.FDC().diffFlux(hp_j, jf)())
    pj, jj = pfdc.jacobian(pf), jfdc.jacobian(jf)
    ph, jh = pfdc.hessian(pf), jfdc.hessian(jf)
    assert pj.keys == jj.keys and set(pj.keys) == {"r", "z"}
    assert ph.keys == jh.keys and set(ph.keys) == {"rr", "rz", "zz"}
    for k in ("r", "z"):
        _close(pj[k], jj[k])
    for k in ("rr", "rz", "zz"):
        _close(ph[k], jh[k])
    assert ph["zr"] is ph.rz


# -- goldens of the original torch reference ------------------------------
@pytest.fixture(scope="module")
def golden():
    import os

    return np.load(os.path.join(os.path.dirname(__file__), "data", "parity_golden.npz"))


def test_golden_poisson_rz(golden):
    """``tests/test_reference_parity.py::test_parity_poisson_rz_solution``
    on the port (1e-6)."""
    mesh = Mesh(Cylinder[0:1, 0:1], None, [41, 41], device="cpu", dtype="double")
    f_bc = CylinderBoundary(
        rl={"bc_type": "neumann", "bc_val": 0.0},
        ru={"bc_type": "dirichlet", "bc_val": lambda g, m, v, o: torch.exp(-g[1]) * cos(1)},
        zl={"bc_type": "dirichlet", "bc_val": lambda g, m, v, o: torch.cos(g[0])},
        zu={"bc_type": "dirichlet", "bc_val": lambda g, m, v, o: torch.cos(g[0]) * exp(-1)},
    )
    var = Field("U", 1, mesh, {"domain": f_bc(), "obstacle": None}, init_val=0.0)
    rv = -torch.sin(mesh.X) / (mesh.X * torch.exp(mesh.Z))
    rhs = torch.where(mesh.X == 0.0, -1.0 / torch.exp(mesh.Z), rv)[None]
    solver = Solver({"fdm": {"method": "bicgstab", "tol": 1e-10, "max_it": 5000,
                             "report": False}})
    solver.set_eq(FDM().laplacian(1.0, var) == rhs)
    assert solver.solve()["converge"]
    np.testing.assert_allclose(_np(var()[0]), golden["poisson_rz"], atol=1e-6, rtol=1e-6)


def test_golden_jacobian_hessian_rz(golden):
    mesh = Mesh(Cylinder[0:2, -2:2], None, [17, 25], device="cpu", dtype="double")
    R, Z = mesh._grid_np
    var = Field("h", 1, mesh, None).set_var_tensor(np.exp(-(R**2 + Z**2) / 2.0)[None])
    jac, hess = pfdc.jacobian(var), pfdc.hessian(var)
    np.testing.assert_allclose(_np(jac.r), golden["jh_jac_r"], atol=1e-12)
    np.testing.assert_allclose(_np(jac.z), golden["jh_jac_z"], atol=1e-12)
    for comp in ("rr", "rz", "zz"):
        np.testing.assert_allclose(_np(getattr(hess, comp)), golden[f"jh_hess_{comp}"],
                                   atol=1e-12)


# -- the 2-D axis stencil on rz vectors -----------------------------------
@pytest.mark.parametrize("name", sorted(BC_SETS))
@pytest.mark.parametrize("shape", [(16, 128), (32, 256)])
def test_axis_stencil_rz_matches_jax_pallas(shape, name):
    """The port's ``axis_stencil`` (its plain version on the CPU) with the
    rz Laplacian vectors against the JAX 2-D Pallas kernel
    (``pallas_stencil.py:432``) in interpret mode."""
    jm, pm = _meshes(((0, 4), (-4, 4)), shape)
    jf = JField("v", 1, jm, {"domain": _bcs(BC_SETS[name], jnp), "obstacle": None})
    pf = Field("v", 1, pm, {"domain": _bcs(BC_SETS[name], torch), "obstacle": None})
    x = np.random.default_rng(2).standard_normal((1, *shape))
    coeffs = pstencil.laplacian_axis_coeffs(pm, pf.bcs)
    want = pallas_axis_stencil(tuple(tuple(jnp.asarray(c) for c in cs) for cs in
                                     jstencil.laplacian_axis_coeffs(jm, jf.bcs)),
                               jnp.asarray(x), interpret=True)
    got = axis_stencil(coeffs_from_numpy(coeffs, "cpu", torch.float64), torch.from_numpy(x))
    _close(got, want)


# -- solves ---------------------------------------------------------------
def _rz_problem(lib, nx=(33, 65)):
    bc = CylinderBoundary if lib is torch else JCylinderBoundary
    return bc(rl={"bc_type": "neumann", "bc_val": 0.0},
              ru={"bc_type": "dirichlet", "bc_val": 0.0},
              zl={"bc_type": "dirichlet", "bc_val": 0.0},
              zu={"bc_type": "dirichlet", "bc_val": 0.0})()


def _solve_both(cfg, nx=(33, 65), bounds=((0, 1), (0, 2)), seed=5):
    jm, pm = _meshes(bounds, nx)
    rhs = np.random.default_rng(seed).standard_normal((1, *nx))
    jv = JField("p", 1, jm, {"domain": _rz_problem(jnp), "obstacle": None}, init_val=0.0)
    pv = Field("p", 1, pm, {"domain": _rz_problem(torch), "obstacle": None}, init_val=0.0)
    js, ps = JSolver({"fdm": dict(cfg)}), Solver({"fdm": dict(cfg)})
    js.set_eq(JFDM().laplacian(1.0, jv) == jnp.asarray(rhs))
    ps.set_eq(FDM().laplacian(1.0, pv) == torch.from_numpy(rhs))
    rj, rp = js.solve(), ps.solve()
    return (_np(jv()), rj), (_np(pv()), rp)


def test_fastdiag_rz():
    """``tests/test_fastdiag.py::test_fastdiag_rz`` on the port: the radial
    operator is nonsymmetric but diagonally symmetrizable (r = 0 with its
    surgery included): one f64 pass lands ~1e-13, FD-preconditioned
    BiCGSTAB converges in 1-2 iterations, and both agree with plain
    BiCGSTAB. The fastdiag solve and the FD-preconditioned one take the
    JAX package's iterations and agree with it to 1e-12. (Plain BiCGSTAB
    runs ~150 iterations here, where round-off moves its count by one
    between any two implementations, so it is held to the solution.)"""
    base = {"tol": 1e-10, "max_it": 5000, "report": False}
    (xj, rj), (xb, rb) = _solve_both({**base, "method": "bicgstab"})
    assert rb["converge"]
    _close(xb, xj, 1e-8)
    (xjf, rjf), (xf, rf) = _solve_both({**base, "method": "fastdiag"})
    assert rf["itr"] <= 2 and rf["tol"] < 1e-12, rf
    assert rf["itr"] == rjf["itr"]
    _close(xf, xjf)
    (xjp, rjp), (xp, rp) = _solve_both({**base, "method": "bicgstab", "precond": "fd"})
    assert rp["itr"] <= 2 and rp["itr"] == rjp["itr"], (rp, rjp)
    _close(xp, xjp)
    for x in (xf, xp):
        assert np.abs(x - xb).max() / np.abs(xb).max() < 1e-8


def test_mg_bicgstab_rz_same_solves_as_jax():
    """``tests/test_multigrid.py::test_mg_bicgstab_rz``: BiCGSTAB with the
    rz multigrid preconditioner takes the JAX package's iterations and
    agrees within the tolerance, ~10x fewer than unpreconditioned."""
    cfg = {"method": "bicgstab", "tol": 1e-8, "max_it": 5000, "report": False}
    (xj, rj), (xp, rp) = _solve_both({**cfg, "precond": "mg"}, nx=(65, 65),
                                     bounds=((0, 1), (0, 1)))
    assert rp["converge"] and rp["itr"] == rj["itr"], (rp, rj)
    _close(xp, xj, 1e-8)
    (_, _), (_, r0) = _solve_both(cfg, nx=(65, 65), bounds=((0, 1), (0, 1)))
    assert rp["itr"] < r0["itr"] / 4, (rp, r0)


@pytest.mark.parametrize("face_kinds", [(("neumann", "dirichlet"), ("dirichlet", "dirichlet")),
                                        (("dirichlet", "dirichlet"), ("neumann", "neumann"))])
@pytest.mark.parametrize("r_lower", [0.0, 0.5])
def test_mg_rz_level_vectors_match_jax(r_lower, face_kinds):
    """Every level's rz vectors (``1 +- dr/(2r)`` at the level spacing,
    the per-level surgery) are the JAX package's ``_rz_axis_coeffs``."""
    shape, lengths = (65, 129), (1.5, 4.0)
    ps = MGSpec(shape, lengths, rz=True, r_lower=r_lower, face_kinds=face_kinds,
                dtype=torch.float64, device="cpu")
    js = JMGSpec(shape, lengths, rz=True, r_lower=r_lower, face_kinds=face_kinds,
                 dtype=jnp.float64)
    assert ps.shapes == js.shapes and len(ps.shapes) > 3
    assert ps.key != MGSpec(shape, lengths, face_kinds=face_kinds, dtype=torch.float64,
                            device="cpu").key
    for shp in ps.shapes:
        for cs_p, cs_j in zip(ps._level_coeffs(shp), js._rz_axis_coeffs(shp)):
            for a, b in zip(cs_p, cs_j):
                _close(a, b, 0.0)
        _close(ps._diag(shp), js._diag(shp, jnp.float64))


def test_mg_rz_takes_no_fused_kernel_or_var_gamma():
    spec = MGSpec((17, 33), (1.0, 2.0), rz=True, fuse_rz=True, device="cpu",
                  dtype=torch.float64)
    assert not spec.fuse_rz and not spec.can_fuse_rz()
    with pytest.raises(AssertionError):
        MGSpec((17, 33), (1.0, 2.0), rz=True, var_gamma=True, device="cpu")


def test_var_gamma_rz_raises_as_in_jax():
    """A variable-Γ Laplacian on rz raises in both packages."""
    jf, pf = _fields(BC_SETS["dir_all"])
    with pytest.raises(NotImplementedError):
        JFDM().laplacian(jnp.ones(jf.mesh.nx), jf)
    with pytest.raises(NotImplementedError):
        FDM().laplacian(torch.ones(pf.mesh.nx, dtype=torch.float64), pf)


def test_poisson_solver_rz_method_matches_jax():
    """``PoissonSolver`` on rz takes plain CG, the JAX package's choice (on
    a box: the fastdiag direct solve); with ``{"method": "bicgstab",
    "precond": "mg"}`` both packages solve alike."""
    from pyapes_tpu.models import PoissonSolver as JPoissonSolver

    jm, pm = _meshes(((0, 1), (0, 1)), (17, 17))
    assert (PoissonSolver(pm, _rz_problem(torch)).solver.config["fdm"]["method"]
            == JPoissonSolver(jm, _rz_problem(jnp)).solver.config["fdm"]["method"] == "cg")
    cfg = {"method": "bicgstab", "precond": "mg", "tol": 1e-10}
    ps = PoissonSolver(pm, _rz_problem(torch), config=cfg)
    js = JPoissonSolver(jm, _rz_problem(jnp), config=cfg)
    rhs = np.random.default_rng(1).standard_normal((17, 17))
    ps.solve(rhs)
    js.solve(jnp.asarray(rhs))
    assert ps.report["converge"] and ps.report["itr"] == js.report["itr"]
    _close(ps.var(), js.var(), 1e-10)
