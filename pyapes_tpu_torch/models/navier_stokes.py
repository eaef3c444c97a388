"""Incompressible Navier-Stokes by incremental pressure-correction
projection: the lid-driven cavity, the channel and the periodic box
(PyTorch port of ``pyapes_tpu/models/navier_stokes.py``).

Semi-implicit scheme on the collocated grid (Goda/van Kan incremental
form by default; ``incremental=False`` is non-incremental Chorin):

1. advection explicit (central, from ``FDC``) or implicit (``fdm.conv``),
   diffusion implicit: ``(I/dt - nu lap) u* = u^n/dt - (u.grad)u - grad
   p^n``;
2. pressure-correction Poisson (homogeneous Neumann, the zero-mean
   quotient): ``lap dp = div(u*) / dt``, with the Rhie-Chow-equivalent
   stabilization;
3. ``p = p^n + dp``; projection ``u = u* - dt grad dp``, velocity BCs.

Each step is eager: the solves go through ``Solver`` (fastdiag for the
separable momentum and pressure systems; BiCGSTAB with the FD
preconditioner for implicit advection; plain BiCGSTAB for the momentum
with immersed bodies or a per-point viscosity; BiCGSTAB with the
plain-domain V-cycle for a non-singular pressure with bodies) and the
explicit glue is plain PyTorch.

Immersed obstacles on the mesh become no-slip bodies: the velocities take
obstacle-Dirichlet 0 (shell pinned, solid interior zeroed each step), the
pressure obstacle-Neumann (a zero-flux wall). ``ChannelFlow`` is the
inflow/outflow channel or duct, and the force functions integrate the
hydrodynamic force on a body: the staircase surface quadrature and the
control-volume momentum balance, each in a host form (numpy result) and a
device form (a device vector, no host sync).

The viscosity is a scalar or a per-point field: a field (given, set by
``update_viscosity``, or re-evaluated each step from the strain rate by
``mu_strain_fn``, e.g. one of the laws below) makes the momentum
diffusion the conservative ``div(mu grad u_j)`` (a variable-Γ term, the
``diff_field`` kernel) plus the explicit transpose source
``sum_k d_k(mu) d_j(u_k)``. ``PeriodicFlow`` is the fully periodic box
(Taylor-Green, the 3-D TGV with Smagorinsky LES, the Beltrami flow).

``run(fused=True)``, ``run_batched`` and ``fused_runner`` step through the
fused whole-step runner (``utils/fuse.py``): on the card one CUDA graph per
step, its solver loops WHILE nodes; on the CPU the same state-swap step
with ``sync: False`` solves.
"""
from __future__ import annotations


import numpy as np
import torch

from pyapes_tpu_torch.geometry.basis import DIR_TO_NUM, FDIR
from pyapes_tpu_torch.geometry.mask import MaskObstacle
from pyapes_tpu_torch.mesh import Mesh
from pyapes_tpu_torch.parallel import blocks
from pyapes_tpu_torch.solver.fdc import FDC
from pyapes_tpu_torch.solver.fdm import FDM
from pyapes_tpu_torch.solver.ops import Solver
from pyapes_tpu_torch.variables import Field


def _ddx(f: torch.Tensor, dx: float, axis: int, periodic: bool = False) -> torch.Tensor:
    """Central difference with one-sided second-order edges of a raw
    tensor (no Field, no BCs).

    ``periodic=True``: the exact torus stencil on a duplicated-endpoint
    axis (the duplicate seam row dropped, wrapped with ``roll``, restored)."""

    def row(i):
        return (slice(None),) * axis + (i,)

    if periodic:
        fr = f[row(slice(None, -1))]
        d = (torch.roll(fr, -1, axis) - torch.roll(fr, 1, axis)) / (2 * dx)
        return blocks.append_seam(d, axis)
    d = (torch.roll(f, -1, axis) - torch.roll(f, 1, axis)) / (2 * dx)
    d[row(0)] = (-1.5 * f[row(0)] + 2 * f[row(1)] - 0.5 * f[row(2)]) / dx
    d[row(-1)] = (1.5 * f[row(-1)] - 2 * f[row(-2)] + 0.5 * f[row(-3)]) / dx
    return d


def power_law_viscosity(K: float, n: float, eps: float = 1e-6):
    """Regularized Ostwald–de Waele (power-law) law ``mu(γ̇) = K (γ̇² +
    ε²)^{(n-1)/2}``: shear-thinning for n < 1, shear-thickening for
    n > 1, Newtonian K at n = 1 (ε bounds mu where γ̇ → 0). Returns a
    ``gamma_dot -> mu`` callable for ``mu_strain_fn``."""
    ex = 0.5 * (n - 1.0)

    def mu(gdot):
        return K * (gdot * gdot + eps * eps) ** ex

    return mu


def carreau_viscosity(mu0: float, mu_inf: float, lam: float, n: float):
    """Carreau–Yasuda (a = 2) law ``mu(γ̇) = mu_inf + (mu0 - mu_inf) (1 +
    (λ γ̇)²)^{(n-1)/2}``: bounded at zero shear (mu0) and at infinite
    shear (mu_inf). Returns a ``gamma_dot -> mu`` callable for
    ``mu_strain_fn``."""
    ex = 0.5 * (n - 1.0)

    def mu(gdot):
        return mu_inf + (mu0 - mu_inf) * (1.0 + (lam * gdot) ** 2) ** ex

    return mu


def smagorinsky_viscosity(nu: float, mesh: Mesh, cs: float = 0.17, damping=None):
    """Smagorinsky LES eddy viscosity ``nu_eff(|S|) = nu + (C_s Δ)² |S|``
    with ``Δ = (Π dx_j)^{1/dim}`` and ``|S| = sqrt(2 S:S)`` (what
    ``strain_rate`` returns), for ``mu_strain_fn``.

    ``damping``: an optional per-point array multiplying ``(C_s Δ)²`` (e.g.
    a Van Driest wall-damping factor), kept as a tensor on the mesh's
    device; None: no damping."""
    delta = float(np.prod(np.asarray(mesh.dx_np))) ** (1.0 / mesh.dim)
    c2 = (cs * delta) ** 2
    if damping is not None:
        c2 = c2 * torch.as_tensor(damping, dtype=mesh.dtype.float, device=mesh.device)

    def mu(gdot):
        return nu + c2 * gdot

    return mu


def _obstacle_setup(mesh: Mesh):
    """No-slip immersed bodies (JAX ``navier_stokes.py:117-137``): the
    obstacle BC configs of the velocities (Dirichlet 0) and the pressure
    (zero-flux Neumann), the solid mask and a 2-cell dilation of it, both
    bool tensors on the mesh's device (or four Nones without obstacles)."""
    if mesh.obstacle is None:
        return None, None, None, None
    uv = [{"bc_type": "dirichlet", "bc_val": 0.0}] * len(mesh.obstacle)
    p = [{"bc_type": "neumann", "bc_val": 0.0}] * len(mesh.obstacle)
    body = np.zeros(tuple(mesh.nx), dtype=bool)
    for m in mesh.obstacle_body_masks:
        body |= m
    near = body.copy()
    for _ in range(2):
        grown = near.copy()
        for ax in range(near.ndim):
            grown |= np.roll(near, 1, ax) | np.roll(near, -1, ax)
        near = grown
    return (uv, p, torch.as_tensor(body, device=mesh.device),
            torch.as_tensor(near, device=mesh.device))


def _fluid_neighbours(body: np.ndarray, device) -> list:
    """``(axis, sign, fluid mask)`` per surface-shell face of ``body``: the
    fluid cell one step along the outward normal of each shell cell (the
    roll is a bijection, so the correspondence is exact), the masks bool
    tensors on ``device``."""
    out = []
    for f, shell in MaskObstacle.shells(body).items():
        if shell.any():
            ax = DIR_TO_NUM[f[0]]
            sgn = -1 if f[1] == "l" else +1
            out.append((ax, sgn, torch.as_tensor(np.roll(shell, sgn, axis=ax), device=device)))
    return out


def staircase_body_force(p, vels, body, dx, nu, u_body=None) -> np.ndarray:
    """Hydrodynamic force on an immersed solid (per unit density; 2-D: per
    unit depth), ``F = ∮ (-p n + nu du/dn) dS`` over the staircase surface
    of the boolean ``body`` mask (JAX ``navier_stokes.py:139-174``).

    First-order immersed-boundary quadrature: the pressure is sampled at
    the fluid neighbour of each surface cell and the traction uses the
    one-sided normal derivative ``(u_fluid - u_body)/dx`` (no slip on a
    body that may translate with ``u_body``). A constant pressure
    integrates to zero exactly (the staircase normals close).

    Returns a numpy vector of ``len(dx)`` components."""
    return staircase_body_force_device(p, vels, body, dx, nu, u_body=u_body).cpu().numpy()


def staircase_body_force_device(p, vels, body, dx, nu, u_body=None) -> torch.Tensor:
    """The device form of ``staircase_body_force``: a ``(dim,)`` tensor on
    ``p``'s device, computed without a host sync."""
    p = torch.as_tensor(p)
    body = np.asarray(body.cpu() if isinstance(body, torch.Tensor) else body, dtype=bool)
    return _staircase_sum(p, vels, _fluid_neighbours(body, p.device), dx, nu, u_body)


def _staircase_sum(p, vels, fluid_faces, dx, nu, u_body=None) -> torch.Tensor:
    """The staircase quadrature over the fluid-neighbour masks
    ``fluid_faces`` of ``_fluid_neighbours``."""
    dim = len(dx)
    ub = [0.0] * dim if u_body is None else [float(c) for c in u_body]
    dv = 1.0
    for d in dx:
        dv *= float(d)
    vels = [torch.as_tensor(v, dtype=p.dtype, device=p.device) for v in vels]
    F = [torch.zeros((), dtype=p.dtype, device=p.device) for _ in range(dim)]
    for ax, sgn, fluid in fluid_faces:
        dS = dv / float(dx[ax])
        F[ax] = F[ax] + (-sgn * torch.sum(torch.where(fluid, p, 0.0)) * dS)
        for i, v in enumerate(vels):
            dudn = torch.sum(torch.where(fluid, v, 0.0) - fluid.to(v.dtype) * ub[i])
            F[i] = F[i] + nu * dudn / float(dx[ax]) * dS
    return torch.stack(F)


def control_volume_force(p, vels, dx, lo, hi, nu, vels_old=None, dt=None) -> np.ndarray:
    """Momentum-balance (control-volume) force on the body enclosed by the
    node box ``[lo, hi]`` (per unit density; 2-D: per unit depth; JAX
    ``navier_stokes.py:205-321``)::

        F_i = - d/dt ∫_CV u_i dV  -  ∮_S u_i (u·n) dS
              + ∮_S ( -p n_i + nu (du_i/dx_n + du_n/dx_i) ) dS

    Every term is evaluated on CV faces in smooth fluid away from the
    body, with central differences and trapezoidal quadrature: second
    order, where the staircase traction is first order.

    Args:
        p: pressure ``(*nx)``; vels: velocity components, each ``(*nx)``.
        dx: grid spacings per axis.
        lo/hi: inclusive node bounds of the CV box per axis; every face
            plane needs an interior neighbour on each side.
        nu: kinematic viscosity, a scalar or a per-point ``(*nx)`` array.
        vels_old/dt: previous-step velocities and the step for the
            unsteady term; omit both for a steady flow.

    Returns a numpy vector of ``len(dx)`` components (host float64),
    computed by ``control_volume_force_device`` on float64 tensors."""
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    p = f64(p)
    nu = f64(nu).to(p.device) if getattr(nu, "ndim", 0) else nu
    vels = [f64(v).to(p.device) for v in vels]
    if vels_old is not None:
        vels_old = [f64(v).to(p.device) for v in vels_old]
    dt = None if dt is None else float(dt)
    return control_volume_force_device(p, vels, dx, lo, hi, nu, vels_old, dt).cpu().numpy()


def _grad_tang(arr: torch.Tensor, d: float, axis: int) -> torch.Tensor:
    """``np.gradient(edge_order=2)`` along ``axis`` of a face plane:
    central interior, second-order one-sided ends."""
    g = (torch.roll(arr, -1, axis) - torch.roll(arr, 1, axis)) / (2 * d)

    def sl(i):
        return (slice(None),) * axis + (i,)

    g[sl(0)] = (-3 * arr[sl(0)] + 4 * arr[sl(1)] - arr[sl(2)]) / (2 * d)
    g[sl(-1)] = (3 * arr[sl(-1)] - 4 * arr[sl(-2)] + arr[sl(-3)]) / (2 * d)
    return g


def control_volume_force_device(p, vels, dx, lo, hi, nu, vels_old=None, dt=None) -> torch.Tensor:
    """The device form of ``control_volume_force`` (JAX
    ``navier_stokes.py:324-416``): the same quadrature on static slices of
    the device tensors, the trapezoid weights made on the device, so a
    per-step diagnostic makes no host sync. Returns a ``(dim,)`` tensor."""
    dim = p.ndim
    dx = [float(d) for d in dx]
    lo = [int(v) for v in lo]
    hi = [int(v) for v in hi]
    for a in range(dim):
        assert 1 <= lo[a] and hi[a] <= p.shape[a] - 2 and lo[a] < hi[a], (
            f"control_volume_force: CV box {lo}..{hi} needs an interior neighbor on each side "
            f"of every face (grid {tuple(p.shape)})"
        )
    nu_arr = nu if getattr(nu, "ndim", 0) else None

    def trapz(n_nodes):
        w = torch.ones(n_nodes, dtype=p.dtype, device=p.device)
        w[0].fill_(0.5)  # a fill on the device (an item assignment copies from the host)
        w[-1].fill_(0.5)
        return w

    F = [torch.zeros((), dtype=p.dtype, device=p.device) for _ in range(dim)]
    if vels_old is not None and dt is not None:
        vol_sl = tuple(slice(lo[a], hi[a] + 1) for a in range(dim))
        w_vol = None
        for a in range(dim):
            shape = [1] * dim
            shape[a] = -1
            wa = trapz(hi[a] - lo[a] + 1).reshape(shape)
            w_vol = wa if w_vol is None else w_vol * wa
        dv = float(np.prod(dx))
        for i in range(dim):
            dudt = (vels[i][vol_sl] - vels_old[i][vol_sl]) / dt
            F[i] = F[i] - torch.sum(w_vol * dudt) * dv
    for a in range(dim):
        dS = float(np.prod([dx[j] for j in range(dim) if j != a]))
        tang = [j for j in range(dim) if j != a]
        w = None
        for t_i, j in enumerate(tang):
            shape = [1] * (dim - 1)
            shape[t_i] = -1
            wj = trapz(hi[j] - lo[j] + 1).reshape(shape)
            w = wj if w is None else w * wj
        for k, sgn in ((lo[a], -1.0), (hi[a], +1.0)):
            plane, plane_p, plane_m = (
                tuple(slice(lo[j], hi[j] + 1) if j != a else kk for j in range(dim))
                for kk in (k, k + 1, k - 1)
            )
            pa = p[plane]
            ua = vels[a][plane]
            nu_f = nu_arr[plane] if nu_arr is not None else float(nu)
            for i in range(dim):
                ui = vels[i][plane]
                F[i] = F[i] - sgn * torch.sum(w * ui * ua) * dS
                dui_da = (vels[i][plane_p] - vels[i][plane_m]) / (2 * dx[a])
                dua_di = dui_da if i == a else _grad_tang(ua, dx[i], tang.index(i))
                F[i] = F[i] + sgn * torch.sum(w * nu_f * (dui_da + dua_di)) * dS
            F[a] = F[a] - sgn * torch.sum(w * pa) * dS
    return torch.stack(F)


class LidDrivenCavity:
    """Lid-driven cavity in 2-D or 3-D, Re = U L / nu; the top wall (yu in
    2-D, zu in 3-D) moves along +x.

    With obstacles on the mesh, they are immersed no-slip bodies: the
    velocities take obstacle-Dirichlet 0 (the shell pinned, the solid
    interior zeroed each step) and the pressure obstacle-Neumann (a
    zero-flux wall).

    Args:
        mesh: Box mesh (optionally with obstacles).
        nu: kinematic viscosity, a scalar or a per-point ``(*nx)`` field
            (a stacked ``(dim, *nx)`` one raises ``ValueError``).
        lid_velocity: a float, or a callable ``U(t)`` evaluated at the new
            time level of each step.
        lid_profile: "uniform" (the singular classic cavity) or
            "regularized" (``U 16 s^2 (1-s)^2`` per lid-tangential axis:
            velocity and its derivative vanish at the corners).
        spanwise: 3-D only, the BCs of the y faces: "noslip", "symmetry" or
            "periodic" (the spanwise-invariant quasi-2-D cavity).
        config: FDM solver config overrides; an explicit ``method`` or
            ``precond`` is taken wholesale.
        mu_strain_fn: a ``gamma_dot -> mu`` law: the viscosity field is
            re-evaluated from the strain rate at the start of each step.
    """

    def __init__(self, mesh: Mesh, nu: float = 0.01, lid_velocity=1.0, config=None,
                 implicit_advection: bool = False, rhie_chow: bool = True,
                 incremental: bool = True, lid_profile: str = "uniform",
                 spanwise: str = "noslip", mu_strain_fn=None):
        assert mesh.dim in (2, 3) and mesh.coord_sys == "xyz"
        assert lid_profile in ("uniform", "regularized")
        assert spanwise in ("noslip", "symmetry", "periodic")
        self.mesh = mesh
        self.nu = self._init_viscosity(nu, mu_strain_fn)
        self.lid = lid_velocity
        self.implicit_advection = implicit_advection
        self.rhie_chow = rhie_chow
        self.incremental = incremental

        dim = mesh.dim
        faces = FDIR[: 2 * dim]
        lid_face = faces[2 * dim - 1]

        lo = [float(v) for v in mesh._lower_np]
        ln = [float(u) - l for u, l in zip(mesh._upper_np, lo)]
        reg_axes = [0] if (dim == 2 or spanwise != "noslip") else [0, 1]

        def _lid_mag(t):
            if callable(lid_velocity):
                return lid_velocity(0.0 if t is None else t)
            return float(lid_velocity)

        if lid_profile == "regularized":
            def lid_val(grid, mask, var, opt, t):
                prof = 1.0
                for j in reg_axes:
                    s = (grid[j] - lo[j]) / ln[j]
                    prof = prof * 16.0 * (s * (1.0 - s)) ** 2
                return _lid_mag(t) * prof
        elif callable(lid_velocity):
            def lid_val(grid, mask, var, opt, t):
                return _lid_mag(t)
        else:
            lid_val = float(lid_velocity)

        span_faces = ("yl", "yu") if dim == 3 else ()

        def vel_bc(component: int):
            out = []
            for f in faces:
                if f in span_faces and spanwise == "periodic":
                    bc = {"bc_type": "periodic", "bc_val": None}
                elif f in span_faces and spanwise == "symmetry" and component != 1:
                    bc = {"bc_type": "symmetry", "bc_val": None}
                elif f == lid_face and component == 0:
                    bc = {"bc_type": "dirichlet", "bc_val": lid_val}
                else:
                    bc = {"bc_type": "dirichlet", "bc_val": 0.0}
                out.append({"bc_face": f, "bc_val_opt": None, **bc})
            return out

        p_periodic = [f in span_faces and spanwise == "periodic" for f in faces]
        p_bc = [{"bc_face": f, "bc_type": "periodic" if per else "neumann",
                 "bc_val": None if per else 0.0, "bc_val_opt": None}
                for f, per in zip(faces, p_periodic)]

        self._make_fields(vel_bc, p_bc)
        # all-Neumann pressure: singular, solved on the zero-mean quotient
        self._singular_pressure = True
        self._init_solvers(config)

    def _make_fields(self, vel_bc, p_bc) -> None:
        """The velocity and pressure Fields, with the no-slip and zero-flux
        obstacle BCs of the mesh's immersed bodies."""
        mesh = self.mesh
        uv_obs, p_obs, self._body, self._body_near = _obstacle_setup(mesh)
        names = ("u", "v", "w")[:mesh.dim]
        self.vel = [Field(nm, 1, mesh, {"domain": vel_bc(j), "obstacle": uv_obs}, init_val=0.0)
                    for j, nm in enumerate(names)]
        self.u = self.vel[0]
        self.v = self.vel[1]
        if mesh.dim == 3:
            self.w = self.vel[2]
        self.p = Field("p", 1, mesh, {"domain": p_bc, "obstacle": p_obs}, init_val=0.0)

    def _init_solvers(self, config) -> None:
        """The JAX package's solver choice (``navier_stokes.py:569-690``):
        fastdiag for the separable momentum (BiCGSTAB with the frozen
        diffusion+dt FD preconditioner under implicit advection; plain
        BiCGSTAB with immersed bodies or a per-point viscosity) and for the
        all-Neumann pressure (CG with MG as the fallback), each with
        ``fd_fallback``; an explicit
        ``method``/``precond`` is taken wholesale. A pressure with bodies
        takes BiCGSTAB with the plain-domain V-cycle when it is
        non-singular (the Neumann shell elimination is nonsymmetric), plain
        CG on the zero-mean quotient when it is singular."""
        config = config or {}
        obstacle = self.mesh.obstacle is not None
        const_nu = self._nu_field is None and self.mu_strain_fn is None
        mom_cfg = {"method": "bicgstab", "tol": 1e-8, "max_it": 500, "report": False}
        if any(k in config for k in ("method", "precond")):
            pass
        elif obstacle or not const_nu:
            pass  # plain BiCGSTAB
        elif not self.implicit_advection:
            mom_cfg.update({"method": "fastdiag", "fd_fallback": "bicgstab"})
        else:
            mom_cfg.update({"precond": "fd", "fd_fallback": "bicgstab"})
        mom_cfg.update(config)
        self.mom_solver = Solver({"fdm": dict(mom_cfg)})
        p_cfg = dict(mom_cfg)
        p_cfg.update({"method": "cg", "tol": min(1e-5, float(config.get("tol", 1e-5))),
                      "max_it": 2000, "criterion": "residual"})
        if self._singular_pressure:
            p_cfg["nullspace"] = "mean"
        if "precond" not in config:
            p_cfg.pop("precond", None)
            p_cfg.pop("fd_fallback", None)
        if not obstacle and "method" not in config and "precond" not in config:
            p_cfg.update({"method": "fastdiag", "fd_fallback": "cg", "precond": "mg"})
        if "precond" not in p_cfg:
            if not obstacle:
                p_cfg["precond"] = "mg"
            elif not self._singular_pressure:
                p_cfg.update({"precond": "mg", "method": "bicgstab"})
        self.p_solver = Solver({"fdm": p_cfg})
        self.dp = self.p.zeros_like("dp")
        if not hasattr(self, "_rc_mask"):
            self._rc_mask = None
        self.fdm = FDM()
        self._fdc = FDC({"grad": {"edge": True}, "laplacian": {"edge": True}})
        self.t = 0.0

    def _grad(self, field: Field) -> torch.Tensor:
        """FDC gradient of a scalar Field: ``(mesh.dim, *nx)``."""
        return self._fdc.grad(field, edge=True)[0]

    def _advect(self, field: Field) -> torch.Tensor:
        g = self._grad(field)
        out = self.vel[0]()[0] * g[0]
        for j in range(1, self.mesh.dim):
            out = out + self.vel[j]()[0] * g[j]
        return out

    def _extra_momentum_rhs(self, component: int):
        """Per-component explicit momentum source (the buoyancy of
        ``NaturalConvection``): a ``(*nx)`` tensor or 0.0."""
        return 0.0

    # -- variable viscosity (JAX navier_stokes.py:706-798) ------------------
    def _init_viscosity(self, nu, mu_strain_fn=None):
        """A per-point ``(*nx)`` viscosity becomes the model's viscosity
        field (a tensor on the mesh's device); a scalar stays as it is.
        Returns the scalar to keep as ``nu`` (a field's mean). A stacked
        ``(dim, *nx)`` field raises ``ValueError``: the explicit transpose
        stress takes an isotropic viscosity."""
        self._nu_field = None
        self.mu_strain_fn = mu_strain_fn
        if getattr(nu, "ndim", 0) > 0:
            arr = self._as_field(nu)
            if arr.ndim != self.mesh.dim:
                raise ValueError(
                    f"viscosity field must be per-point (shape {tuple(self.mesh.nx)}); got "
                    f"{tuple(arr.shape)} — anisotropic (stacked) viscosity is not supported"
                )
            self._nu_field = arr
            return float(torch.mean(arr.double()))
        return nu

    def _as_field(self, a) -> torch.Tensor:
        """A tensor or array as a tensor on the mesh's device, in its
        float dtype."""
        return torch.as_tensor(a, dtype=self.mesh.dtype.float, device=self.mesh.device)

    def strain_rate(self, gu=None) -> torch.Tensor:
        """Shear-rate magnitude ``γ̇ = sqrt(2 S:S)`` of the current
        velocities (S the symmetric velocity gradient). ``gu``: the
        gradients ``[grad(u_k)]`` when the caller has them."""
        dim = self.mesh.dim
        if gu is None:
            gu = [self._grad(v) for v in self.vel]  # gu[k][j] = d_j u_k
        ss = None
        for k in range(dim):
            for j in range(dim):
                s = 0.5 * (gu[k][j] + gu[j][k])
                ss = s * s if ss is None else ss + s * s
        return torch.sqrt(2.0 * ss)

    def update_viscosity(self, mu) -> None:
        """Replace the per-point viscosity field (e.g. mu(T) each step)."""
        self._nu_field = self._as_field(mu)

    def _nu_coeff(self):
        """The momentum diffusion coefficient: the viscosity field when
        there is one, else the scalar."""
        return self.nu if self._nu_field is None else self._nu_field

    def _array_grad(self, arr: torch.Tensor) -> list:
        """Per-axis derivative of a raw tensor: second-order central in the
        interior, first-order one-sided at the ends."""
        out = []
        for j in range(self.mesh.dim):
            d = float(self.mesh.dx_np[j])
            g = (torch.roll(arr, -1, j) - torch.roll(arr, 1, j)) / (2 * d)
            row = lambda i: (slice(None),) * j + (i,)  # noqa: E731
            # the end rows (of a block vector: in the blocks that hold them)
            take = lambda i: blocks.take(arr, row(i))  # noqa: E731
            blocks.set_at(g, row(0), (take(1) - take(0)) / d)
            blocks.set_at(g, row(-1), (take(-1) - take(-2)) / d)
            out.append(g)
        return out

    def _visc_transpose_rhs(self, gu=None) -> list:
        """The explicit transpose-stress source ``sum_k d_k(mu) d_j(u_k)``
        (``div(mu grad u^T)_j`` of an incompressible flow; zero for a
        constant mu). ``gu``: the velocity gradients when at hand."""
        dmu = self._array_grad(self._nu_field)
        if gu is None:
            gu = [self._grad(v) for v in self.vel]
        return [sum(dmu[k] * gu[k][j] for k in range(self.mesh.dim))
                for j in range(self.mesh.dim)]

    def _refresh_strain_viscosity(self) -> None:
        """Re-evaluate the strain-rate viscosity from the current
        velocities (after a run, as the JAX package's fused run does, so a
        reader sees the field of the state it holds)."""
        if self.mu_strain_fn is not None:
            self.update_viscosity(self.mu_strain_fn(self.strain_rate()))

    def step(self, dt: float) -> None:
        mesh = self.mesh
        dim = mesh.dim

        # the time-n velocity gradients, shared by the strain-rate viscosity
        # and the transpose-stress source
        gu_n = None
        if self.mu_strain_fn is not None:
            gu_n = [self._grad(v) for v in self.vel]
            self.update_viscosity(self.mu_strain_fn(self.strain_rate(gu_n)))

        # 1. momentum: implicit diffusion, advection explicit (from the
        # time-n velocities) or implicit (Picard-linearized fdm.conv)
        for var in self.vel:
            if var._dt is None:
                var.set_time(dt, self.t)
            else:
                var._dt = dt  # dt may change between steps (run_adaptive)
            var.save_old()
            # the solves and BCs of this step belong to the new time level
            var.update_time(dt)
        if self.incremental:
            gp_old = self._grad(self.p)
            rhs_pg = [-gp_old[j] for j in range(dim)]
        else:
            rhs_pg = [0.0] * dim
        rhs_pg = [rhs_pg[j] + self._extra_momentum_rhs(j) for j in range(dim)]
        if self._nu_field is not None:
            trans = self._visc_transpose_rhs(gu_n)
            rhs_pg = [rhs_pg[j] + trans[j] for j in range(dim)]
        if self.implicit_advection:
            uvec = torch.cat([v() for v in self.vel], dim=0)
            for j, var in enumerate(self.vel):
                self.mom_solver.set_eq(
                    self.fdm.ddt(var) + self.fdm.conv(uvec, var)
                    - self.fdm.laplacian(self._nu_coeff(), var)
                    == torch.zeros_like(var()) + rhs_pg[j]
                )
                self.mom_solver.solve()
        else:
            # every component's advection from the time-n velocities,
            # before any momentum solve overwrites them
            rhs_all = [(-self._advect(var) + rhs_pg[j])[None] for j, var in enumerate(self.vel)]
            for j, var in enumerate(self.vel):
                self.mom_solver.set_eq(
                    self.fdm.ddt(var) - self.fdm.laplacian(self._nu_coeff(), var) == rhs_all[j]
                )
                self.mom_solver.solve()

        for var in self.vel:
            var.apply_bcs()

        # 2. pressure Poisson: lap p = div(u*) / dt (+ the Rhie-Chow term)
        div_star = self._grad(self.vel[0])[0]
        for j in range(1, dim):
            div_star = div_star + self._grad(self.vel[j])[j]
        rhs_p = div_star / dt
        if self.rhie_chow:
            # (lap_c - lap_w) p: the compact operator solved minus the wide
            # one the projection removes, whose difference is the
            # collocated checkerboard mode; the bulk only
            gp = self._grad(self.p)
            paxes = {bc.bc_face_dim for bc in (self.p.bcs or []) if bc.bc_type == "periodic"}
            lap_w = sum(_ddx(gp[j], float(mesh.dx_np[j]), j, periodic=j in paxes)
                        for j in range(dim))
            lap_c = self._fdc.laplacian(self.p, edge=True)[0]
            rc = lap_c - lap_w
            if self._rc_mask is None:
                m = torch.zeros(tuple(mesh.nx), dtype=torch.bool, device=rc.device)
                m[(slice(2, -2),) * dim] = True
                self._rc_mask = m
            rc = torch.where(self._rc_mask, rc, 0.0)
            if self._body_near is not None:
                # the wide operator reaches 2 cells through a body (its
                # solid p values are extrapolation artifacts): fluid only
                rc = torch.where(self._body_near, 0.0, rc)
            # incremental: p accumulates p += dp, so the damped fixed point
            # needs the opposite sign
            rhs_p = rhs_p - rc if self.incremental else rhs_p + rc
        if self._singular_pressure:
            rhs_p = rhs_p - torch.mean(rhs_p)
        ptgt = self.dp if self.incremental else self.p
        if self.incremental:
            self.dp.set_var_tensor(torch.zeros_like(self.dp()))
        self.p_solver.set_eq(self.fdm.laplacian(1.0, ptgt) == rhs_p[None])
        self.p_solver.solve()
        if self.incremental:
            self.p.set_var_tensor(self.p() + self.dp())
        if self._singular_pressure:
            p = self.p()[0]
            self.p.set_var_tensor((p - torch.mean(p))[None])

        # 3. projection (incremental: with grad(dp) only) + BCs
        gp = self._grad(ptgt)
        new_vals = [self.vel[j]()[0] - dt * gp[j] for j in range(dim)]
        if self._body is not None:
            # no slip in the whole solid (the obstacle BC pins the shell)
            new_vals = [torch.where(self._body, 0.0, nv) for nv in new_vals]
        for var, nv in zip(self.vel, new_vals):
            var.set_var_tensor(nv[None])
            var.apply_bcs()

        self.t = self.t + dt  # rebinds: a fused step streams t as a tensor

    def state_fields(self) -> list:
        """The Fields whose values and history evolve across steps."""
        fields = list(self.vel) + [self.p]
        if self.incremental:
            fields.append(self.dp)
        return fields

    # device constants a step builds lazily: kept across the fused core's
    # restore of the model's attributes (built at an eager warm-up)
    _fused_caches = ("_rc_mask", "_fluid_faces", "_cv_box_cache")

    def fused_runner(self, donate: bool = False):
        """The whole-step runner (``utils/fuse.py``): on the card the
        explicit glue and the implicit solves of a step are one CUDA graph,
        replayed per step. ``donate=True`` steps the state in place in the
        graph's buffers (see ``FusedStepRunner``)."""
        if getattr(self, "_fused", None) is None:
            from pyapes_tpu_torch.utils.fuse import FusedStepRunner

            self._fused = FusedStepRunner(self, donate=donate)
        return self._fused

    def _bootstrap_steps(self, dt: float, n_steps: int, fused: bool) -> tuple[int, bool]:
        """Advance through the history bootstrap (until two levels exist),
        fused when asked (JAX ``navier_stokes.py:973-1023``). The first
        step's state lacks ``_VARoo``, so it gets a one-shot runner of its
        own; from the second step on the structure is the steady one, so
        the model's runner takes it and is reused for the rest of the run.
        Returns ``(steps_remaining, capturable)``; ``capturable`` goes
        False when a capture failed (the rest of the bootstrap then ran
        eagerly, with a warning)."""
        from pyapes_tpu_torch.utils.fuse import CaptureError, FusedStepRunner

        while n_steps > 0 and min(v.n_hist for v in self.vel) < 2:
            if fused:
                try:
                    if min(v.n_hist for v in self.vel) == 0:
                        FusedStepRunner(self).step(dt)
                    else:
                        self.fused_runner().step(dt)
                except CaptureError as e:
                    # state untouched (fuse.py restores it whole): eager
                    # for the rest of the run
                    import warnings

                    warnings.warn("fused step capture failed; falling back to eager stepping: "
                                  f"{type(e).__name__}: {e}")
                    fused = False
                    self._fused = None
                    self.step(dt)
            else:
                self.step(dt)
            n_steps -= 1
        return n_steps, fused

    def run(self, dt: float, n_steps: int, fused: bool = False) -> None:
        """``n_steps`` steps of ``dt``, eager or fused (``fused=True``: the
        bootstrap, then the model's fused runner; a capture that fails warns
        and falls back to eager steps); a strain-rate viscosity is then
        re-evaluated from the final velocities (a fused step restores the
        model's attributes, so its viscosity field is the warm-up's)."""
        if fused:
            n_steps, fused = self._bootstrap_steps(dt, n_steps, fused=True)
            if fused and n_steps > 0:
                from pyapes_tpu_torch.utils.fuse import CaptureError

                try:
                    self.fused_runner().run(dt, n_steps)
                    n_steps = 0
                except CaptureError as e:
                    import warnings

                    warnings.warn("fused step capture failed; falling back to eager stepping: "
                                  f"{type(e).__name__}: {e}")
                    self._fused = None
        for _ in range(n_steps):
            self.step(dt)
        self._refresh_strain_viscosity()

    def run_batched(self, dt: float, n_steps: int, diag_fn=None):
        """``n_steps`` fused steps (``FusedStepRunner.run_batched``, JAX
        ``navier_stokes.py:1235-1265``) with optional per-step diagnostics
        ``diag_fn: model -> pytree of tensors`` (e.g. ``body_force_device``),
        kept on the device. The history bootstrap runs first, fused, and
        carries no diagnostics. Returns the stacked diagnostics (leading
        axis: the steps after the bootstrap) or None. When a capture fails
        the steps run eagerly with a warning, and ``diag_fn`` is evaluated
        after each of them: the same stacked series (where the JAX package
        returns None)."""
        import warnings

        from pyapes_tpu_torch.utils.fuse import CaptureError, _stack

        n_steps, fused = self._bootstrap_steps(dt, n_steps, fused=True)
        if n_steps > 0 and fused:
            try:
                diags = self.fused_runner().run_batched(dt, n_steps, diag_fn)
                self._refresh_strain_viscosity()
                return diags
            except CaptureError as e:
                warnings.warn(f"run_batched: step capture failed; stepping eagerly: "
                              f"{type(e).__name__}: {e}")
                self._fused = None
        elif n_steps > 0:
            warnings.warn("run_batched: step capture failed during bootstrap; stepping eagerly")
        eager = []
        for _ in range(n_steps):
            self.step(dt)
            if diag_fn is not None:
                eager.append(diag_fn(self))
        diags = _stack(eager) if eager else None
        self._refresh_strain_viscosity()
        return diags

    def max_velocity(self) -> torch.Tensor:
        """``max_j max|u_j|`` as a device scalar."""
        m = torch.max(torch.abs(self.vel[0]()))
        for v in self.vel[1:]:
            m = torch.maximum(m, torch.max(torch.abs(v())))
        return m

    def run_adaptive(self, cfl: float, t_end: float, *, dt_max: float | None = None,
                     dt_min: float = 1e-12, max_steps: int = 100_000) -> int:
        """CFL-adaptive transient loop, ``dt_n = cfl min(dx) / max|u^n|``,
        capped by ``dt_max`` (default ``cfl * min(dx)``) and shortened to
        land on ``t_end``; a required dt below ``dt_min`` raises. One
        device-to-host read (``max|u|``) per step. Returns the number of
        steps taken."""
        dx_min = min(float(d) for d in self.mesh.dx_np)
        if dt_max is None:
            dt_max = cfl * dx_min
        n = 0
        while self.t < t_end - 1e-12 and n < max_steps:
            umax = float(self.max_velocity())
            dt = cfl * dx_min / umax if umax > 0 else dt_max
            dt = min(dt, dt_max, t_end - self.t)
            if dt < dt_min:
                raise RuntimeError(
                    f"run_adaptive: required dt {dt:.3e} < dt_min ({dt_min:.3e}) at "
                    f"t={self.t:.6f} (max|u|={umax:.3e})"
                )
            self.step(dt)
            n += 1
        return n

    def divergence(self) -> torch.Tensor:
        out = self._grad(self.vel[0])[0]
        for j in range(1, self.mesh.dim):
            out = out + self._grad(self.vel[j])[j]
        return out

    # -- forces on immersed bodies (JAX navier_stokes.py:1122-1233) --------
    def _force_args(self, idx: int):
        assert self.mesh.obstacle is not None, "body_force: no obstacles"
        return (self.p()[0], [v()[0] for v in self.vel], self.mesh.obstacle_body_masks[idx],
                [float(d) for d in self.mesh.dx_np], self.nu)

    def body_force(self, idx: int = 0) -> np.ndarray:
        """Hydrodynamic force on obstacle ``idx`` by the staircase
        quadrature (``staircase_body_force``): a numpy vector of
        ``mesh.dim`` components (drag = component 0 in the channel, lift
        = component 1)."""
        return staircase_body_force(*self._force_args(idx))

    def body_force_device(self, idx: int = 0) -> torch.Tensor:
        """``body_force`` as a device vector, with no host sync: a per-step
        diagnostic gathered on the card and fetched once. The body's
        fluid-neighbour masks are uploaded once and kept on the model."""
        p, vels, body, dx, nu = self._force_args(idx)
        fluid = self.__dict__.setdefault("_fluid_faces", {})
        if idx not in fluid:
            fluid[idx] = _fluid_neighbours(body, p.device)
        return _staircase_sum(p, vels, fluid[idx], dx, nu)

    def _cv_box(self, idx: int, margin: int):
        """The CV node box ``(lo, hi)`` of obstacle ``idx``: its bounding
        box grown by ``margin`` nodes, checked once (then cached) to have
        every face plane in the fluid of every body."""
        cache = self.__dict__.setdefault("_cv_box_cache", {})
        if (idx, margin) in cache:
            return cache[(idx, margin)]
        assert self.mesh.obstacle is not None, "body_force_cv: no obstacles"
        nx = self.mesh.nx
        idxs = np.where(self.mesh.obstacle_body_masks[idx])
        lo = [max(1, int(ii.min()) - margin) for ii in idxs]
        hi = [min(int(n) - 2, int(ii.max()) + margin) for ii, n in zip(idxs, nx)]
        solid = np.zeros(tuple(nx), dtype=bool)
        for m in self.mesh.obstacle_body_masks:
            solid |= m
        for a in range(len(nx)):
            for k in (lo[a], hi[a]):
                plane = tuple(slice(lo[j], hi[j] + 1) if j != a else k for j in range(len(nx)))
                assert not solid[plane].any(), (
                    f"body_force_cv: CV face {a}@{k} intersects a body; reduce margin or check "
                    "obstacle placement"
                )
        cache[(idx, margin)] = (lo, hi)
        return lo, hi

    def _cv_history(self, dt):
        """The previous-step velocities and the step of the unsteady term,
        or ``(None, None)`` before the first step."""
        if dt is None or not all(v.n_hist > 0 for v in self.vel):
            return None, None
        return [v.VARo[0] for v in self.vel], dt

    def body_force_cv(self, idx: int = 0, margin: int = 4) -> np.ndarray:
        """Hydrodynamic force on obstacle ``idx`` by the control-volume
        momentum balance (``control_volume_force``) over its bounding box
        grown by ``margin`` nodes; the unsteady term uses the fields'
        previous step (``VARo``) once a step has been taken."""
        lo, hi = self._cv_box(idx, margin)
        vo, dt = self._cv_history(self.vel[0]._dt)
        return control_volume_force(self.p()[0], [v()[0] for v in self.vel],
                                    [float(d) for d in self.mesh.dx_np], lo, hi, self._nu_coeff(),
                                    vels_old=vo, dt=None if dt is None else float(dt))

    def body_force_cv_device(self, idx: int = 0, margin: int = 4, dt=None) -> torch.Tensor:
        """``body_force_cv`` as a device vector, with no host sync; ``dt``
        defaults to the fields' current step."""
        lo, hi = self._cv_box(idx, margin)
        vo, dt = self._cv_history(self.vel[0]._dt if dt is None else dt)
        return control_volume_force_device(self.p()[0], [v()[0] for v in self.vel],
                                           [float(d) for d in self.mesh.dx_np], lo, hi,
                                           self._nu_coeff(), vels_old=vo, dt=dt)


class ChannelFlow(LidDrivenCavity):
    """Pressure-projected channel or duct flow with inflow and outflow
    (JAX ``navier_stokes.py:1268-1362``; 2-D channel or 3-D rectangular
    duct).

    Parabolic inflow at ``xl`` (2-D: ``u = 4 U s (1-s)``, ``s`` the
    transverse coordinate over the width; 3-D: the product of two such
    profiles), outflow at ``xu`` (zero-gradient velocity, ``p = 0``: the
    pressure Poisson is non-singular), no-slip walls, and the mesh's
    immersed no-slip obstacles (flow past a body).

    Args:
        mesh: Box mesh on [0, Lx] x [0, Ly] (x [0, Lz]), optionally with
            obstacles.
        nu: kinematic viscosity, a scalar (Re = U Ly / nu) or a per-point
            field.
        u_in: the inflow centreline scale U.
        mu_strain_fn: a ``gamma_dot -> mu`` law (e.g.
            ``power_law_viscosity``), re-evaluated each step.
    """

    def __init__(self, mesh: Mesh, nu: float = 0.01, u_in: float = 1.0, config=None,
                 implicit_advection: bool = False, rhie_chow: bool = True,
                 incremental: bool = True, mu_strain_fn=None):
        assert mesh.dim in (2, 3) and mesh.coord_sys == "xyz"
        self.mesh = mesh
        self.nu = self._init_viscosity(nu, mu_strain_fn)
        self.u_in = float(u_in)
        self.lid = 0.0
        self.implicit_advection = implicit_advection
        self.rhie_chow = rhie_chow
        self.incremental = incremental

        dim = mesh.dim
        lo = [float(v) for v in mesh._lower_np]
        ln = [float(u) - l for u, l in zip(mesh._upper_np, lo)]
        u_scale = self.u_in

        def inflow(grid, mask, var, opt):
            prof = 1.0
            for j in range(1, dim):
                s = (grid[j] - lo[j]) / ln[j]
                prof = prof * 4.0 * s * (1.0 - s)
            return u_scale * prof

        self._inflow = inflow
        faces = FDIR[: 2 * dim]
        d0 = {"bc_type": "dirichlet", "bc_val": 0.0}
        nm = {"bc_type": "neumann", "bc_val": 0.0}

        def bc_list(xl_bc, xu_bc, wall_bc):
            return [dict(bc_face=f, bc_val_opt=None,
                         **(xl_bc if f == "xl" else xu_bc if f == "xu" else wall_bc))
                    for f in faces]

        u_dom = bc_list({"bc_type": "dirichlet", "bc_val": inflow}, nm, d0)
        t_dom = bc_list(d0, nm, d0)  # the transverse components
        self._make_fields(lambda j: u_dom if j == 0 else t_dom, bc_list(nm, d0, nm))
        self.u.apply_bcs()
        self._singular_pressure = False
        self._init_solvers(config)

    def flux(self, i: int) -> float:
        """Volume flux through grid cross-section ``i`` (trapezoidal over the
        transverse axes); one host read."""
        u = self.u()[0][i].cpu().numpy()
        for j in range(1, self.mesh.dim):
            u = _trapezoid(u, dx=float(self.mesh.dx_np[j]), axis=0)
        return float(u)


class PeriodicFlow(LidDrivenCavity):
    """Incompressible Navier-Stokes on a fully periodic box (JAX
    ``navier_stokes.py:1364-1497``): every velocity component and the
    pressure are periodic on all faces, the singular pressure Poisson is
    solved on the zero-mean quotient of the torus-reduced system.

    The exact anchor is the decaying Taylor-Green vortex on ``[0, 1]^2``
    (``u = -cos(2 pi x) sin(2 pi y) e^{-8 pi^2 nu t}``, ``v = sin(2 pi x)
    cos(2 pi y) e^{-8 pi^2 nu t}``): the nonlinear term is a pure gradient
    absorbed by the pressure. Immersed obstacles on the mesh are no-slip
    bodies, as in the cavity.

    Args:
        advection_form: "skew" (the energy-conserving split ``(u.grad phi +
            div(u phi)) / 2``: on a uniform torus with central differences
            its quadratic aliasing errors cancel, so under-resolved
            turbulence stays bounded), "advective", or "auto" (skew without
            obstacles, advective with them: a body breaks the integration
            by parts the split rests on).
        The other arguments are the cavity's.
    """

    def __init__(self, mesh: Mesh, nu: float = 0.01, config=None,
                 implicit_advection: bool = False, rhie_chow: bool = True,
                 incremental: bool = True, mu_strain_fn=None, advection_form: str = "auto"):
        assert mesh.dim in (2, 3) and mesh.coord_sys == "xyz"
        self.mesh = mesh
        self.nu = self._init_viscosity(nu, mu_strain_fn)
        self.lid = 0.0
        self.implicit_advection = implicit_advection
        self.rhie_chow = rhie_chow
        self.incremental = incremental
        if advection_form == "auto":
            advection_form = "skew" if mesh.obstacle is None else "advective"
        assert advection_form in ("advective", "skew")
        self.advection_form = advection_form

        per = [{"bc_face": f, "bc_type": "periodic", "bc_val": None, "bc_val_opt": None}
               for f in FDIR[: 2 * mesh.dim]]
        self._make_fields(lambda j: per, per)
        # no walls or corners: the Rhie-Chow mismatch is O(h^2) everywhere,
        # so the whole torus is stabilized
        self._rc_mask = torch.ones(tuple(mesh.nx), dtype=torch.bool, device=mesh.device)
        self._singular_pressure = True
        self._init_solvers(config)

    def _torus_dj(self, a: torch.Tensor, j: int) -> torch.Tensor:
        """Exact-torus central derivative along axis ``j`` of a raw tensor
        whose end rows are duplicates: the seam row dropped, rolled, the
        wrap row restored."""
        r = a.narrow(j, 0, a.shape[j] - 1)
        d = (torch.roll(r, -1, j) - torch.roll(r, 1, j)) / (2.0 * float(self.mesh.dx_np[j]))
        return blocks.append_seam(d, j)

    def _advect(self, field: Field) -> torch.Tensor:
        """Explicit advection; the skew form averages the advective and the
        divergence forms."""
        adv = super()._advect(field)
        if self.advection_form != "skew":
            return adv
        phi = field()[0]
        div = None
        for j in range(self.mesh.dim):
            t = self._torus_dj(self.vel[j]()[0] * phi, j)
            div = t if div is None else div + t
        return 0.5 * (adv + div)

    def set_velocity(self, *components) -> None:
        """Set the velocity (one ``(*nx)`` tensor or array per component)
        and re-apply the periodic wraps."""
        assert len(components) == self.mesh.dim
        for var, arr in zip(self.vel, components):
            var.set_var_tensor(self._as_field(arr)[None])
            var.apply_bcs()

    def put_state(self, decomp) -> None:
        """Put the model's state on the blocks of the placed ``decomp`` (the
        counterpart of the JAX package's fields once GSPMD has sharded
        them): each state Field's value and history (``blocks.put``: an
        axis of ``2^k + 1`` nodes cut as its torus, the seam plane in the
        last block), the viscosity field and the Rhie-Chow mask. The steps
        then run block by block (the strain rate, the viscosity law, the
        skew split, the projection), and the solves take the Fields'
        blocks and keep their solutions there."""
        for f in self.state_fields():
            put = {}
            for level in ("_VAR", "_VARo", "_VARoo"):
                v = getattr(f, level, None)
                if isinstance(v, torch.Tensor) and not isinstance(v, blocks.BlockTensor):
                    if id(v) not in put:  # the levels that share a tensor keep sharing it
                        put[id(v)] = blocks.put(v, decomp)
                    setattr(f, level, put[id(v)])
        if self._nu_field is not None:
            self._nu_field = blocks.put(self._nu_field[None], decomp)[0]
        self._rc_mask = blocks.put(self._rc_mask[None], decomp)[0]

    def kinetic_energy(self) -> torch.Tensor:
        """Volume-integrated kinetic energy as a device scalar (the wrap row
        of each axis left out, so nothing counts twice)."""
        red = (slice(None, -1),) * self.mesh.dim
        ke = sum(0.5 * v()[0][red] ** 2 for v in self.vel)
        dv = 1.0
        for d in self.mesh.dx_np:
            dv = dv * float(d)
        return torch.sum(ke) * dv


_trapezoid = getattr(np, "trapezoid", None) or np.trapz
