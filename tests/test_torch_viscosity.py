"""The viscosity laws and the per-point viscosity of the port's flow models
against the JAX package (CPU, float64).

* Each law (power law, Carreau, Smagorinsky with and without damping)
  equal to the JAX package's on a random shear-rate grid within 1e-14
  relative.
* ``strain_rate``, ``_array_grad`` and the transpose-stress source on the
  same velocities within 1e-12.
* From one carried state (``utils/carry.py``, the viscosity field
  included), with ``{"method": "bicgstab", "precond": None}`` where the
  pressure is not periodic (both packages then resolve the same solves:
  the JAX package's fastdiag probe rejects every domain BC and takes its
  Krylov fallback, the port solves a separable pressure by fastdiag,
  ``tests/test_torch_navier_stokes.py``): the cavity with a per-point ν,
  with a Smagorinsky or a Carreau law, ``NaturalConvection`` with ``mu_fn`` and with ``k_fn``, the
  channel with a power law and the 3-D TGV with Smagorinsky LES at 17^3
  (10 steps) — the same ``itr`` solve by solve and the fields within 1e-8.
* The gates of the five JAX viscosity tests of ``tests/test_models.py``
  on the port's own runs (eager where the JAX test steps ``fused=True``:
  the fused runner's parity is ``tests/test_torch_fuse.py``'s; an eager
  run ends, as the fused one does, with the strain-rate viscosity of the
  final velocities).
"""
from math import pi

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import pyapes_tpu.models as jmodels  # noqa: E402
from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
import pyapes_tpu_torch.models as pmodels  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops.stencil import apply_diff_field  # noqa: E402
from pyapes_tpu_torch.solver.linalg import build as build_mod  # noqa: E402
from pyapes_tpu_torch.solver.linalg import dispatch as dispatch_mod  # noqa: E402
from pyapes_tpu_torch.utils.carry import model_state_from_numpy  # noqa: E402


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _meshes(nx, upper=None):
    upper = upper or [1.0] * len(nx)
    box = tuple(slice(0, u) for u in upper)
    return (JMesh(JBox[box], None, list(nx), dtype="double"),
            Mesh(Box[box], None, list(nx), device="cpu", dtype="double"))


LAWS = {
    "power_law": lambda m, pkg: pkg.power_law_viscosity(K=0.05, n=0.5, eps=1e-3),
    "power_law_thickening": lambda m, pkg: pkg.power_law_viscosity(K=0.3, n=1.4),
    "carreau": lambda m, pkg: pkg.carreau_viscosity(mu0=0.1, mu_inf=0.01, lam=2.0, n=0.4),
    "smagorinsky": lambda m, pkg: pkg.smagorinsky_viscosity(0.01, m, cs=0.17),
    "smagorinsky_damped": lambda m, pkg: pkg.smagorinsky_viscosity(
        0.01, m, cs=0.2, damping=(1.0 - np.exp(-np.asarray(m._grid_np[1]) / 0.1)) ** 2),
}


@pytest.mark.parametrize("law", sorted(LAWS))
def test_viscosity_laws_match_jax(law):
    jm, pm = _meshes((17, 9))
    gdot = np.abs(np.random.default_rng(4).standard_normal((17, 9))) * 10.0
    want = np.asarray(LAWS[law](jm, jmodels)(jnp.asarray(gdot)))
    got = _np(LAWS[law](pm, pmodels)(torch.as_tensor(gdot)))
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()


def _shear_fields(nx):
    rng = np.random.default_rng(6)
    return [rng.standard_normal((1, *nx)) for _ in nx]


@pytest.mark.parametrize("nx", [(17, 13), (9, 11, 7)])
def test_strain_rate_and_transpose_source_match_jax(nx):
    jm, pm = _meshes(nx)
    jc = jmodels.LidDrivenCavity(jm, nu=np.ones(nx))
    pc = pmodels.LidDrivenCavity(pm, nu=np.ones(nx))
    mu = 1.0 + np.random.default_rng(7).random(nx)
    jc.update_viscosity(jnp.asarray(mu))
    pc.update_viscosity(mu)
    for jv, pv, a in zip(jc.vel, pc.vel, _shear_fields(nx)):
        jv.set_var_tensor(jnp.asarray(a))
        pv.set_var_tensor(torch.as_tensor(a))
    assert_allclose(_np(pc.strain_rate()), np.asarray(jc.strain_rate()), rtol=0, atol=1e-12)
    for a, b in zip(pc._array_grad(pc._nu_field), jc._array_grad(jc._nu_field)):
        assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-12)
    for a, b in zip(pc._visc_transpose_rhs(), jc._visc_transpose_rhs()):
        assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-12)


def test_stacked_viscosity_raises():
    _, pm = _meshes((9, 9))
    with pytest.raises(ValueError, match="per-point"):
        pmodels.LidDrivenCavity(pm, nu=np.ones((2, 9, 9)))


# -- same solves from one carried state ------------------------------------------

def _record_itr(model, out: list) -> None:
    for solver in (model.mom_solver, model.p_solver):
        real = solver.solve

        def solve(real=real):
            rep = real()
            out.append(rep["itr"])
            return rep

        solver.solve = solve


def _state(model) -> list:
    return [(_np(f()), _np(f.VARo)) for f in model.state_fields()]


def _carry_and_step(jm, pm, dt, steps, warm=1):
    """``warm`` JAX steps, the state (viscosity field included) carried
    over, then ``steps`` steps in both: ``(jax itr, port itr, max field
    difference)``."""
    jm.run(dt, warm)
    nu = None if jm._nu_field is None else np.asarray(jm._nu_field)
    model_state_from_numpy(pm, _state(jm), t=jm.t, nu_field=nu)
    jitr, pitr = [], []
    _record_itr(jm, jitr)
    _record_itr(pm, pitr)
    jm.run(dt, steps)
    pm.run(dt, steps)
    err = max(np.abs(_np(a()) - _np(b())).max()
              for a, b in zip(jm.state_fields(), pm.state_fields()))
    return jitr, pitr, err


KRYLOV = {"method": "bicgstab", "precond": None}


def _cavity_pair(nx, config=None, **kw):
    jmesh, pmesh = _meshes(nx)
    jk = {k: (v(jmesh, jmodels) if callable(v) else v) for k, v in kw.items()}
    pk = {k: (v(pmesh, pmodels) if callable(v) else v) for k, v in kw.items()}
    return (jmodels.LidDrivenCavity(jmesh, config=config, **jk),
            pmodels.LidDrivenCavity(pmesh, config=config, **pk))


def _nu_field(nx):
    g = np.meshgrid(*[np.linspace(0, 1, n) for n in nx], indexing="ij")
    return 0.01 * (1.0 + 0.5 * g[0] + 0.3 * g[1])


CAVITIES = {
    "nu_field_2d": ((17, 17), {"nu": _nu_field((17, 17))}),
    "nu_field_3d_implicit": ((9, 9, 9), {"nu": _nu_field((9, 9, 9)),
                                         "implicit_advection": True}),
    "smagorinsky_2d": ((17, 17), {"nu": 2e-3, "lid_profile": "regularized",
                                  "mu_strain_fn": LAWS["smagorinsky"]}),
    "carreau_2d_chorin": ((17, 17), {"nu": 0.05, "incremental": False,
                                     "mu_strain_fn": LAWS["carreau"]}),
    "power_law_3d": ((9, 9, 9), {"nu": 0.05, "mu_strain_fn": LAWS["power_law"]}),
}


@pytest.mark.parametrize("case", sorted(CAVITIES))
def test_cavity_variable_viscosity_same_solves_as_jax(case):
    nx, kw = CAVITIES[case]
    # the default config: plain BiCGSTAB for a variable-viscosity momentum
    mom = _cavity_pair(nx, **kw)[1].mom_solver.config["fdm"]
    assert mom["method"] == "bicgstab" and "precond" not in mom
    jm, pm = _cavity_pair(nx, config=dict(KRYLOV), **kw)
    jitr, pitr, err = _carry_and_step(jm, pm, 0.02, 5)
    assert pitr == jitr and len(pitr) == 5 * (len(nx) + 1)
    assert err <= 1e-8
    assert abs(pm.nu - jm.nu) <= 1e-15
    if pm.mu_strain_fn is not None:
        # the port's run ends with the field of the final velocities, as the
        # JAX package's fused run does (its eager run keeps the last step's)
        jm._refresh_strain_viscosity()
        assert_allclose(_np(pm._nu_field), np.asarray(jm._nu_field), rtol=1e-10, atol=0)


@pytest.mark.parametrize("which", ["mu_fn", "k_fn"])
def test_natural_convection_properties_same_solves_as_jax(which):
    jmesh, pmesh = _meshes((17, 17))
    fns = {"mu_fn": (lambda T: 0.71 * jnp.exp(-0.6931 * T),
                     lambda T: 0.71 * torch.exp(-0.6931 * T)),
           "k_fn": (lambda T: 1.0 + T, lambda T: 1.0 + T)}[which]
    jm = jmodels.NaturalConvection(jmesh, ra=1e3, pr=0.71, config=dict(KRYLOV),
                                   **{which: fns[0]})
    pm = pmodels.NaturalConvection(pmesh, ra=1e3, pr=0.71, config=dict(KRYLOV),
                                   **{which: fns[1]})
    jitr, pitr, err = _carry_and_step(jm, pm, 0.0125, 4, warm=2)
    assert pitr == jitr and len(pitr) == 4 * 4
    assert err <= 1e-8 * max(np.abs(_np(f())).max() for f in jm.state_fields())
    assert abs(pm.nusselt_hot_wall() - jm.nusselt_hot_wall()) < 1e-9


def test_channel_power_law_same_solves_as_jax():
    jmesh, pmesh = _meshes((25, 17), upper=[3.0, 1.0])
    jm = jmodels.ChannelFlow(jmesh, nu=0.05, config=dict(KRYLOV),
                             mu_strain_fn=jmodels.power_law_viscosity(K=0.05, n=0.5, eps=1e-3))
    pm = pmodels.ChannelFlow(pmesh, nu=0.05, config=dict(KRYLOV),
                             mu_strain_fn=pmodels.power_law_viscosity(K=0.05, n=0.5, eps=1e-3))
    jitr, pitr, err = _carry_and_step(jm, pm, 0.01, 5)
    assert pitr == jitr and len(pitr) == 5 * 3
    assert err <= 1e-8
    assert abs(pm.flux(1) - jm.flux(1)) <= 1e-10


def test_tgv3d_les_17_same_solves_as_jax():
    """The 3-D Taylor-Green vortex at Re 1600 with Smagorinsky (cs 0.17) at
    17^3, dt = 0.2 dx, 10 steps from the initial field (the JAX test's
    set-up at a small grid)."""
    n, L, nu = 17, 2 * pi, 1.0 / 1600.0
    jmesh, pmesh = _meshes((n, n, n), upper=[L] * 3)
    jm = jmodels.PeriodicFlow(jmesh, nu=nu, mu_strain_fn=jmodels.smagorinsky_viscosity(
        nu, jmesh, cs=0.17))
    pm = pmodels.PeriodicFlow(pmesh, nu=nu, mu_strain_fn=pmodels.smagorinsky_viscosity(
        nu, pmesh, cs=0.17))
    X, Y, Z = (np.asarray(g) for g in jmesh._grid_np)
    u0 = (np.sin(X) * np.cos(Y) * np.cos(Z), -np.cos(X) * np.sin(Y) * np.cos(Z),
          np.zeros_like(X))
    jm.set_velocity(*[jnp.asarray(a) for a in u0])
    pm.set_velocity(*u0)
    assert abs(float(pm.kinetic_energy()) / L**3 - 0.125) < 2e-3
    jitr, pitr = [], []
    _record_itr(jm, jitr)
    _record_itr(pm, pitr)
    dt = 0.2 * L / (n - 1)
    jm.run(dt, 10)
    pm.run(dt, 10)
    assert pitr == jitr and len(pitr) == 40
    for a, b in zip(jm.state_fields(), pm.state_fields()):
        assert np.abs(_np(b()) - np.asarray(a())).max() <= 1e-8
    assert abs(float(pm.kinetic_energy()) - float(jm.kinetic_energy())) <= 1e-10


# -- the JAX viscosity tests' gates on the port ------------------------------------

def test_variable_viscosity_stress_mms():
    """``tests/test_models.py::test_variable_viscosity_stress_mms``: the
    implicit conservative part plus the explicit transpose source converge
    at second order on a manufactured incompressible field."""
    def err_at(n):
        mesh = Mesh(Box[0:1, 0:1], None, [n, n], device="cpu", dtype="double")
        model = pmodels.LidDrivenCavity(mesh, nu=np.ones((n, n)), lid_velocity=0.0)
        X, Y = (np.asarray(g) for g in mesh._grid_np)
        mu = 1.0 + 0.5 * X + 0.3 * Y
        model.update_viscosity(mu)
        u = np.pi * np.sin(np.pi * X) * np.cos(np.pi * Y)
        v = -np.pi * np.cos(np.pi * X) * np.sin(np.pi * Y)
        model.vel[0].set_var_tensor(torch.as_tensor(u)[None])
        model.vel[1].set_var_tensor(torch.as_tensor(v)[None])
        ux = np.pi**2 * np.cos(np.pi * X) * np.cos(np.pi * Y)
        uy = -np.pi**2 * np.sin(np.pi * X) * np.sin(np.pi * Y)
        vx = np.pi**2 * np.sin(np.pi * X) * np.sin(np.pi * Y)
        vy = -np.pi**2 * np.cos(np.pi * X) * np.cos(np.pi * Y)
        mux, muy = 0.5, 0.3
        S = [mu * (-2 * np.pi**2 * u) + mux * ux + muy * uy + (mux * ux + muy * vx),
             mu * (-2 * np.pi**2 * v) + mux * vx + muy * vy + (mux * uy + muy * vy)]
        inv_dx2 = tuple(1.0 / float(d) ** 2 for d in mesh.dx_np)
        trans = model._visc_transpose_rhs()
        errs = []
        for j, w in enumerate((u, v)):
            impl = _np(apply_diff_field(torch.as_tensor(w)[None], torch.as_tensor(mu), inv_dx2,
                                        (("none", "none"),) * 2))[0]
            errs.append(np.abs(impl + _np(trans[j]) - S[j])[2:-2, 2:-2].max())
        return max(errs)

    e33, e65 = err_at(33), err_at(65)
    assert e65 < e33 / 3.2, (e33, e65)


def _port_mesh(nx, upper=None):
    return _meshes(nx, upper)[1]


def test_natural_convection_variable_viscosity():
    """``test_models.py::test_natural_convection_variable_viscosity``: a
    constant ``mu_fn`` reproduces the scalar path; mu(T) = 0.71 e^{-0.69 T}
    stays physical and builds no more than three eigen-factorizations."""
    n = 33
    m_ref = pmodels.NaturalConvection(_port_mesh((n, n)), ra=1e3, pr=0.71)
    m_ref.run(dt=0.0125, n_steps=12)
    m_fn = pmodels.NaturalConvection(_port_mesh((n, n)), ra=1e3, pr=0.71,
                                     mu_fn=lambda T: 0.71 * torch.ones_like(T))
    m_fn.run(dt=0.0125, n_steps=12)
    assert_allclose(_np(m_fn.T()[0]), _np(m_ref.T()[0]), rtol=0, atol=2e-5)
    assert_allclose(_np(m_fn.v()[0]), _np(m_ref.v()[0]), rtol=0, atol=2e-4)
    m_var = pmodels.NaturalConvection(_port_mesh((n, n)), ra=1e3, pr=0.71,
                                      mu_fn=lambda T: 0.71 * torch.exp(-0.6931 * T))
    dispatch_mod.clear_cache()
    m_var.run(dt=0.0125, n_steps=40)
    assert len(build_mod._FD_CACHE) <= 3, len(build_mod._FD_CACHE)
    T = _np(m_var.T()[0])
    assert T.max() <= 1.0 + 1e-6 and T.min() >= -1e-6
    nu_wall = m_var.nusselt_hot_wall()
    assert 1.0 < nu_wall < 2.0, nu_wall


def test_channel_power_law_shear_thinning():
    """``test_models.py::test_channel_power_law_shear_thinning``: 49 x 33,
    n = 0.5, 300 steps: u_max/u_mean towards (2n+1)/(n+1) = 4/3."""
    model = pmodels.ChannelFlow(_port_mesh((49, 33), [3.0, 1.0]), nu=0.05, u_in=1.0,
                                mu_strain_fn=pmodels.power_law_viscosity(K=0.05, n=0.5,
                                                                         eps=1e-3))
    model.run(dt=0.01, n_steps=300)
    u = _np(model.u()[0])
    ratio = u[40].max() / u[40].mean()
    assert 1.22 < ratio < 1.44, ratio
    assert abs(model.flux(1) - model.flux(47)) / model.flux(1) < 0.02


def test_natural_convection_nonlinear_conduction_k_of_T():
    """``test_models.py::test_natural_convection_nonlinear_conduction_k_of_T``:
    k(T) = 1 + T at Ra 1 reaches ``T(x) = -1 + sqrt(4 - 3x)``."""
    n = 33
    mesh = _port_mesh((n, n))
    model = pmodels.NaturalConvection(mesh, ra=1.0, pr=0.71, k_fn=lambda T: 1.0 + T)
    model.run(dt=0.05, n_steps=60)
    X = np.asarray(mesh._grid_np[0])[:, n // 2]
    T = _np(model.T()[0])[:, n // 2]
    assert np.abs(T - (-1.0 + np.sqrt(4.0 - 3.0 * X))).max() < 0.01


def test_smagorinsky_les_closure_and_high_re_cavity():
    """``test_models.py::test_smagorinsky_les_closure_and_high_re_cavity``:
    the closure on pure shear (|S| = 1 exactly), the damping array, and the
    under-resolved Re 5000 cavity (65^2, 150 steps): bounded, the eddy
    viscosity active in the shear layer and never negative."""
    n = 33
    mesh = _port_mesh((n, n))
    nu_mol = 0.01
    model = pmodels.LidDrivenCavity(mesh, nu=nu_mol, lid_velocity=1.0,
                                    mu_strain_fn=pmodels.smagorinsky_viscosity(nu_mol, mesh))
    Y = torch.as_tensor(mesh._grid_np[1])
    model.vel[0].set_var_tensor(Y[None])
    model.vel[1].set_var_tensor(torch.zeros_like(Y)[None])
    gdot = _np(model.strain_rate())
    assert_allclose(gdot[2:-2, 2:-2], 1.0, rtol=0, atol=1e-6)
    delta = float(np.prod(np.asarray(mesh.dx_np))) ** 0.5
    nu_eff = _np(pmodels.smagorinsky_viscosity(nu_mol, mesh, cs=0.17)(torch.as_tensor(gdot)))
    assert_allclose(nu_eff[2:-2, 2:-2], nu_mol + (0.17 * delta) ** 2, rtol=1e-6)
    nu_d = pmodels.smagorinsky_viscosity(nu_mol, mesh, cs=0.17, damping=np.zeros((n, n)))(
        torch.ones((n, n), dtype=torch.float64))
    assert_allclose(_np(nu_d), nu_mol, rtol=0, atol=1e-12)

    nu_mol = 2e-4
    mesh2 = _port_mesh((65, 65))
    les = pmodels.LidDrivenCavity(mesh2, nu=nu_mol, lid_velocity=1.0, lid_profile="regularized",
                                  mu_strain_fn=pmodels.smagorinsky_viscosity(nu_mol, mesh2,
                                                                             cs=0.17))
    les.run(dt=2e-3, n_steps=150)
    u, v = _np(les.vel[0]()), _np(les.vel[1]())
    assert np.isfinite(u).all() and np.isfinite(v).all()
    assert np.abs(u).max() <= 1.5 and np.abs(v).max() <= 1.5
    nu_t = _np(les._nu_field) - nu_mol
    assert nu_t.max() > 1.5 * nu_mol, nu_t.max()
    assert nu_t.min() >= -1e-12
