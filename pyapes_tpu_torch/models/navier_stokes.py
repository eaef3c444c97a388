"""Incompressible Navier-Stokes: the lid-driven cavity by incremental
pressure-correction projection (PyTorch port of the cavity of
``pyapes_tpu/models/navier_stokes.py``).

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
preconditioner for implicit advection) and the explicit glue is plain
PyTorch. Scalar viscosity only: a per-point viscosity, ``mu_strain_fn``
and the viscosity laws are a transient variable-Γ momentum solve, and the
fused whole-step runner (``utils/fuse.py``) is a CUDA-graph capture; both
are ported in later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from pyapes_tpu_torch.geometry.basis import FDIR
from pyapes_tpu_torch.mesh import Mesh
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
        return torch.cat([d, d[row(slice(0, 1))]], dim=axis)
    d = (torch.roll(f, -1, axis) - torch.roll(f, 1, axis)) / (2 * dx)
    d[row(0)] = (-1.5 * f[row(0)] + 2 * f[row(1)] - 0.5 * f[row(2)]) / dx
    d[row(-1)] = (1.5 * f[row(-1)] - 2 * f[row(-2)] + 0.5 * f[row(-3)]) / dx
    return d


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"LidDrivenCavity: {what} is ported in a later slice")


class LidDrivenCavity:
    """Lid-driven cavity in 2-D or 3-D, Re = U L / nu; the top wall (yu in
    2-D, zu in 3-D) moves along +x.

    Args:
        mesh: Box mesh (no obstacles: the port's ``Mesh`` raises on them).
        nu: kinematic viscosity, a scalar (a per-point field raises).
        lid_velocity: a float, or a callable ``U(t)`` evaluated at the new
            time level of each step.
        lid_profile: "uniform" (the singular classic cavity) or
            "regularized" (``U 16 s^2 (1-s)^2`` per lid-tangential axis:
            velocity and its derivative vanish at the corners).
        spanwise: 3-D only, the BCs of the y faces: "noslip", "symmetry" or
            "periodic" (the spanwise-invariant quasi-2-D cavity).
        config: FDM solver config overrides; an explicit ``method`` or
            ``precond`` is taken wholesale.
    """

    def __init__(self, mesh: Mesh, nu: float = 0.01, lid_velocity=1.0, config=None,
                 implicit_advection: bool = False, rhie_chow: bool = True,
                 incremental: bool = True, lid_profile: str = "uniform",
                 spanwise: str = "noslip", mu_strain_fn=None):
        assert mesh.dim in (2, 3) and mesh.coord_sys == "xyz"
        assert lid_profile in ("uniform", "regularized")
        assert spanwise in ("noslip", "symmetry", "periodic")
        if getattr(nu, "ndim", 0) > 0:
            raise _later("a per-point viscosity (a transient variable-Γ momentum solve)")
        if mu_strain_fn is not None:
            raise _later("a strain-rate viscosity law (mu_strain_fn)")
        self.mesh = mesh
        self.nu = nu
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

        names = ("u", "v", "w")[:dim]
        self.vel = [Field(nm, 1, mesh, {"domain": vel_bc(j), "obstacle": None}, init_val=0.0)
                    for j, nm in enumerate(names)]
        self.u = self.vel[0]
        self.v = self.vel[1]
        if dim == 3:
            self.w = self.vel[2]
        self.p = Field("p", 1, mesh, {"domain": p_bc, "obstacle": None}, init_val=0.0)

        # all-Neumann pressure: singular, solved on the zero-mean quotient
        self._singular_pressure = True
        self._init_solvers(config)

    def _init_solvers(self, config) -> None:
        """The JAX package's solver choice (``navier_stokes.py:569-688``):
        fastdiag for the separable momentum (BiCGSTAB with the frozen
        diffusion+dt FD preconditioner under implicit advection) and for
        the all-Neumann pressure (CG with MG as the fallback), each with
        ``fd_fallback``; an explicit ``method``/``precond`` is taken
        wholesale, and the pressure then runs CG on the zero-mean quotient
        with that preconditioner."""
        config = config or {}
        mom_cfg = {"method": "bicgstab", "tol": 1e-8, "max_it": 500, "report": False}
        if any(k in config for k in ("method", "precond")):
            pass
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
        if "method" not in config and "precond" not in config:
            p_cfg.update({"method": "fastdiag", "fd_fallback": "cg", "precond": "mg"})
        p_cfg.setdefault("precond", "mg")
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

    def step(self, dt: float) -> None:
        mesh = self.mesh
        dim = mesh.dim

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
        if self.implicit_advection:
            uvec = torch.cat([v() for v in self.vel], dim=0)
            for j, var in enumerate(self.vel):
                self.mom_solver.set_eq(
                    self.fdm.ddt(var) + self.fdm.conv(uvec, var)
                    - self.fdm.laplacian(self.nu, var)
                    == torch.zeros_like(var()) + rhs_pg[j]
                )
                self.mom_solver.solve()
        else:
            # every component's advection from the time-n velocities,
            # before any momentum solve overwrites them
            rhs_all = [(-self._advect(var) + rhs_pg[j])[None] for j, var in enumerate(self.vel)]
            for j, var in enumerate(self.vel):
                self.mom_solver.set_eq(
                    self.fdm.ddt(var) - self.fdm.laplacian(self.nu, var) == rhs_all[j]
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
        for var, nv in zip(self.vel, new_vals):
            var.set_var_tensor(nv[None])
            var.apply_bcs()

        self.t += dt

    def state_fields(self) -> list:
        """The Fields whose values and history evolve across steps."""
        fields = list(self.vel) + [self.p]
        if self.incremental:
            fields.append(self.dp)
        return fields

    def fused_runner(self, donate: bool = False):
        raise _later("the fused whole-step runner (utils/fuse.py)")

    def run_batched(self, *args, **kwargs):
        raise _later("the batched runner (utils/fuse.py)")

    def run(self, dt: float, n_steps: int, fused: bool = False) -> None:
        """``n_steps`` eager steps of ``dt``."""
        if fused:
            raise _later("run(fused=True) (utils/fuse.py)")
        for _ in range(n_steps):
            self.step(dt)

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
