"""Rosenbluth–Fokker–Planck time evolution in rz velocity space (PyTorch
port of ``pyapes_tpu/models/rfp_evolution.py``).

``df/dt = -div(f grad H) + div(hess(G) . grad f)`` with the conservative
RFP operators of ``solver/rfp.py``: explicit forward-Euler steps (a Python
loop where the JAX package scans), and the implicit backward-Euler step
through the ``fdm.custom`` operator with the frozen separable diffusion
surrogate (``rfp_fd_hint``) preconditioning BiCGSTAB.
"""
from __future__ import annotations

import warnings

import torch

from pyapes_tpu_torch.mesh import Mesh
from pyapes_tpu_torch.solver.fdc import hessian, jacobian
from pyapes_tpu_torch.solver.fdm import FDM
from pyapes_tpu_torch.solver.ops import Solver
from pyapes_tpu_torch.solver.rfp import (
    RFP,
    diffusion_apply,
    friction_apply,
    friction_apply_muscl,
    rfp_fd_hint,
)
from pyapes_tpu_torch.variables import Field


class RFPEvolution:
    """RFP stepper with frozen or self-consistent potentials.

    Args:
        mesh: rz (Cylinder) mesh.
        H: friction potential values ``(*nx)``; omit for self-consistent
            use (``run_selfconsistent`` solves them from f).
        G: diffusion potential values ``(*nx)``.
        scheme: the drift of the EXPLICIT paths: "central"
            (``friction_apply``) or "muscl" / "minmod" (TVD-limited
            reconstruction, ``friction_apply_muscl``).
    """

    def __init__(self, mesh: Mesh, H=None, G=None, scheme: str = "central"):
        assert mesh.coord_sys == "rz"
        assert scheme in ("central", "muscl", "minmod")
        self.mesh = mesh
        self.jacH = None
        self.hessG = None
        self._hint = None
        if H is not None:
            self.set_potentials(H, G)
        self.rfp = RFP()
        self.scheme = scheme
        self.report = None

    def _friction(self, Hr, Hz, pdf):
        if self.scheme == "central":
            return friction_apply(Hr, Hz, pdf, self.mesh)
        lim = "mc" if self.scheme == "muscl" else "minmod"
        return friction_apply_muscl(Hr, Hz, pdf, self.mesh, limiter=lim)

    def set_potentials(self, H, G) -> None:
        """(Re)compute the potential derivatives the operators use."""
        hp = Field("H", 1, self.mesh, None)
        gp = Field("G", 1, self.mesh, None)
        self.jacH = jacobian(hp.set_var_tensor(H))
        self.hessG = hessian(gp.set_var_tensor(G))
        self._hint = None

    def fd_hint(self):
        """The separable preconditioner surrogate of the current
        potentials (``rfp_fd_hint``), computed once per ``set_potentials``:
        it reads ``hess G`` to the host, which the steps between two
        refreshes need not repeat."""
        if self._hint is None:
            self._hint = rfp_fd_hint(self.hessG.rr, self.hessG.zz, self.mesh)
        return self._hint

    def rhs(self, f: Field) -> torch.Tensor:
        friction = self.rfp.friction(self.jacH, f)
        diffusion = self.rfp.diffusion(self.hessG, f)
        return -friction + diffusion

    def step_implicit(self, f: Field, dt: float, config=None) -> Field:
        """One backward-Euler step ``(I/dt + Fr - Di) f_new = f/dt``, solved
        matrix-free through ``fdm.custom`` (the RFP operator is linear in f
        with frozen potentials); stable far beyond the explicit limit.

        The default preconditioner is the FD eigen-solve of the frozen
        separable diagonal-diffusion surrogate, ``I/dt - D̄_sep``, once per
        BiCGSTAB iteration; ``config={"precond": "none"}`` turns it off.
        The solve's report is ``self.report``."""
        mesh = self.mesh
        jacH, hessG = self.jacH, self.hessG

        def rfp_op(x, Hr, Hz, Drr, Drz, Dzz):
            return (friction_apply(Hr, Hz, x[0], mesh)
                    - diffusion_apply(Drr, Drz, Dzz, x[0], mesh))[None]

        cfg = {"method": "bicgstab", "tol": 1e-9, "max_it": 2000,
               "report": False, "precond": "fd", "fd_fallback": True}
        cfg.update(config or {})
        solver = Solver({"fdm": cfg})
        fdm = FDM()

        if f._dt is None:
            f.set_time(dt, 0.0)
        f.save_old()
        params = (jacH.r, jacH.z, hessG.rr, hessG.rz, hessG.zz)
        hint = self.fd_hint() if cfg.get("precond") in ("fd", "fastdiag") else None
        solver.set_eq(
            fdm.ddt(f)
            + fdm.custom(rfp_op, f, params=params, fd_hint=hint)
            == torch.zeros_like(f())
        )
        self.report = solver.solve()
        f.update_time(dt)
        return f

    def _explicit_steps(self, pdf, hr, hz, grr, grz, gzz, dt: float, k: int):
        """``k`` forward-Euler steps from ``pdf`` (``(1, *nx)``)."""
        for _ in range(k):
            upd = -self._friction(hr, hz, pdf[0]) + diffusion_apply(grr, grz, gzz, pdf[0],
                                                                    self.mesh)
            pdf = pdf + dt * upd[None]
        return pdf

    def run(self, f: Field, dt: float, n_steps: int) -> Field:
        """Advance ``n_steps`` forward-Euler steps with the potentials set."""
        jacH, hessG = self.jacH, self.hessG
        f.set_var_tensor(self._explicit_steps(f(), jacH.r, jacH.z, hessG.rr, hessG.rz,
                                              hessG.zz, dt, n_steps))
        return f

    def run_selfconsistent(
        self,
        f: Field,
        dt: float,
        n_steps: int,
        refresh_every: int = 1,
        pots=None,
        config: dict | None = None,
    ) -> Field:
        """Advance with the potentials re-solved from f every
        ``refresh_every`` steps (``RosenbluthPotentials``, its two solvers
        reused across refreshes). Warns once when ``dt`` exceeds the
        forward-Euler diffusion stability estimate of ``hess G``."""
        from pyapes_tpu_torch.models.rosenbluth import RosenbluthPotentials

        if pots is None:
            pots = RosenbluthPotentials(self.mesh, f()[0], config)

        pdf = f()
        done = 0
        warned = False
        while done < n_steps:
            k = min(refresh_every, n_steps - done)
            H, G = pots.solve(pdf[0])
            self.set_potentials(H, G)
            if not warned:
                warned = True
                D = float(torch.maximum(self.hessG.rr.abs().max(), self.hessG.zz.abs().max()))
                h2 = float(min(self.mesh.dx_np)) ** 2
                dt_lim = 0.25 * h2 / max(D, 1e-30)
                if dt > dt_lim:
                    warnings.warn(
                        f"explicit RFP step dt={dt:.2e} exceeds the diffusion stability "
                        f"estimate ~{dt_lim:.2e}; expect divergence — reduce dt or use "
                        "step_implicit",
                        stacklevel=2,
                    )
            pdf = self._explicit_steps(pdf, self.jacH.r, self.jacH.z, self.hessG.rr,
                                       self.hessG.rz, self.hessG.zz, float(dt), k)
            done += k
        f.set_var_tensor(pdf)
        return f

