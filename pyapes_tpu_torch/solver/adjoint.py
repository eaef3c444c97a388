"""Differentiable (adjoint) PDE solves via implicit differentiation (port of
``pyapes_tpu/solver/adjoint.py``).

The JAX package wraps its matrix-free Krylov solve in
``jax.lax.custom_linear_solve``; here each solve is a
``torch.autograd.Function`` whose forward runs the solve and whose
backward runs ONE adjoint solve, never a differentiation through the
Krylov iterations:

    x = A(θ)⁻¹ b,   Aᵀ λ = M ∂L/∂x,   ∂L/∂b = M λ,
    ∂L/∂θ = -(M λ)ᵀ ∂(A(θ) x)/∂θ

* ``DifferentiableSolve``: ``A`` is a per-axis 3-vector stencil on the
  masked active set (``M A M``, ``M`` the interior mask), applied through
  the ``ops/axis_stencil.py`` wrapper, so a CUDA tensor launches the axis
  stencil kernel in every forward and adjoint matvec. The adjoint of a
  nonsymmetric operator solves with the analytic stencil transpose
  (``transpose_axis_coeffs``); the coefficient gradients are
  ``-Σ (Mλ) roll(Mx, ∓1)`` and ``-Σ (Mλ)(Mx)``, reduced over the
  components and the other axes.
* ``DifferentiableDiffusionSolve``: ``A = shift I + s ∂_j(Γ ∂_j ·)`` with
  a per-point Γ, applied through the ``ops/diff_field.py`` wrapper (the
  variable-Γ kernel on a CUDA tensor). Its transpose and its Γ-gradient
  are written by hand (``diff_field_transpose``, ``diff_field_gamma_vjp``;
  the JAX package derives both by transposing the traced flux form).
* ``DifferentiableTransient`` / ``DifferentiableTransientDiffusion``: N
  backward-Euler steps, a Python loop of solves; ``checkpoint=True``
  recomputes each step in the backward sweep
  (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``).

The inner Krylov loops are this module's own CG and BiCGSTAB (the JAX
module's ``_cg``/``_bicgstab``: the same stopping rule, no BC
re-application), not the ``linalg`` solvers. Each iteration reads one
scalar to the host (the stopping test). The solution's homogeneous BCs
are applied after the Function, on a clone, so autograd differentiates
those writes itself. ``itr`` holds the last forward and adjoint
iteration counts.

Example:
    >>> dsolve = DifferentiableSolve(mesh, var.bcs)
    >>> loss = torch.sum(dsolve(coeffs, rhs) ** 2)
    >>> loss.backward()          # one extra (adjoint) solve
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from pyapes_tpu_torch.mesh.tools import boundary_slicer, interior_mask_device
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil
from pyapes_tpu_torch.ops.diff_field import diff_field
from pyapes_tpu_torch.ops.stencil import _face, div_surgery_info
from pyapes_tpu_torch.variables.bcs import apply_bcs_fn


def transpose_axis_coeffs(coeffs):
    """Analytic transpose of a per-axis 3-vector stencil (wrap/roll
    semantics): ``(Aᵀ y)[i] = am[i+1] y[i+1] + ac[i] y[i] + ap[i-1] y[i-1]``.
    """
    return tuple((torch.roll(am, -1), ac, torch.roll(ap, 1)) for (ap, ac, am) in coeffs)


def _check_bcs(name: str, bcs, kinds) -> None:
    for bc in bcs or []:
        v = getattr(bc, "bc_val", 0.0)
        if not (v is None or (isinstance(v, (int, float)) and float(v) == 0.0)):
            raise ValueError(f"{name}: BCs must be homogeneous (linear); got {bc.bc_face}={v!r}")
        if bc.bc_type not in kinds:
            raise ValueError(f"{name}: unsupported BC {bc.bc_type}")


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _nan0(v: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)


class _Krylov:
    """The inner solves and the state every differentiable solve shares:
    tolerance, iteration cap, the interior mask per dtype and device, the
    BC application, and the last iteration counts."""

    def __init__(self, mesh, bcs, tol: float, max_it: int, symmetric: bool):
        self.tol = float(tol)
        self.max_it = int(max_it)
        self.symmetric = bool(symmetric)
        self._nx = tuple(mesh.nx)
        self._slicer = tuple(boundary_slicer(mesh.dim, bcs, mesh.coord_sys))
        self._apply_bcs = apply_bcs_fn(list(bcs or []), mesh.grid)
        self._masks: dict = {}
        self.itr = {"forward": 0, "adjoint": 0}
        """Iterations of the last forward and adjoint solves."""

    def mask(self, like: torch.Tensor) -> torch.Tensor:
        key = (like.dtype, like.device)
        if key not in self._masks:
            self._masks[key] = interior_mask_device(self._nx, self._slicer, like.dtype,
                                                    like.device)
        return self._masks[key]

    def _cg(self, matvec, b: torch.Tensor):
        """Plain CG from zero: ``(x, itr)``."""
        tiny = torch.finfo(b.dtype).tiny
        x = torch.zeros_like(b)
        r = b.clone()
        d = b.clone()
        rr = _dot(r, r)
        r0 = torch.sqrt(torch.clamp_min(rr, tiny))
        itr = 0
        while itr < self.max_it and bool(torch.sqrt(rr) / r0 > self.tol):
            Ad = matvec(d)
            alpha = rr / _dot(d, Ad)
            x.addcmul_(alpha, d)
            r.addcmul_(alpha, Ad, value=-1.0)
            rr_new = _dot(r, r)
            d = torch.addcmul(r, rr_new / rr, d)
            rr = rr_new
            itr += 1
        return x, itr

    def _bicgstab(self, matvec, b: torch.Tensor):
        """Plain BiCGSTAB from zero for nonsymmetric operators (the mask
        lives inside ``matvec``): ``(x, itr)``."""
        tiny = torch.finfo(b.dtype).tiny
        r0n = torch.sqrt(torch.clamp_min(_dot(b, b), tiny))
        x = torch.zeros_like(b)
        r = b.clone()
        p = torch.zeros_like(b)
        v = torch.zeros_like(b)
        one = torch.ones((), dtype=b.dtype, device=b.device)
        rho, alpha, omega = one, one, one
        itr = 0
        while itr < self.max_it and bool(torch.sqrt(_dot(r, r)) / r0n > self.tol):
            rho_new = _dot(b, r)
            beta = _nan0(rho_new / rho * alpha / omega)
            p = r + beta * (p - omega * v)
            v = matvec(p)
            alpha = _nan0(rho_new / _dot(b, v))
            s = r - alpha * v
            t = matvec(s)
            omega = _nan0(_dot(t, s) / _dot(t, t))
            x.addcmul_(alpha, p).addcmul_(omega, s)
            r = s - omega * t
            rho = rho_new
            itr += 1
        return x, itr

    def _inner(self, matvec, b, which: str) -> torch.Tensor:
        """CG (symmetric) or BiCGSTAB on ``matvec x = b``; records ``itr``."""
        x, self.itr[which] = (self._cg if self.symmetric else self._bicgstab)(matvec, b)
        return x


def _as_coeff(c, like: torch.Tensor) -> torch.Tensor:
    if isinstance(c, torch.Tensor):
        return c.contiguous()
    return torch.as_tensor(c, dtype=like.dtype, device=like.device)


def _reduce_to_axis(t: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum a ``(vdim, *nx)`` tensor over every dimension but ``axis``."""
    return t.sum(dim=[d for d in range(t.ndim) if d != axis])


class _AxisSolve(torch.autograd.Function):
    """``x = (M A(coeffs) M)⁻¹ (M rhs)``; inputs ``(solver, M, rhs, *the
    coefficient vectors axis by axis, (ap, ac, am) each)``."""

    @staticmethod
    def forward(ctx, solver, M, rhs, *flat):
        coeffs = tuple(tuple(flat[3 * a:3 * a + 3]) for a in range(len(flat) // 3))
        x = solver._inner(lambda v: M * axis_stencil(coeffs, M * v), M * rhs, "forward")
        ctx.solver = solver
        ctx.save_for_backward(M, x, *flat)
        return x

    @staticmethod
    def backward(ctx, g):
        solver = ctx.solver
        M, x, *flat = ctx.saved_tensors
        coeffs = tuple(tuple(flat[3 * a:3 * a + 3]) for a in range(len(flat) // 3))
        op = coeffs if solver.symmetric else transpose_axis_coeffs(coeffs)
        lam = solver._inner(lambda v: M * axis_stencil(op, M * v), M * g, "adjoint")
        mu = M * lam
        grads = [None, None, mu if ctx.needs_input_grad[2] else None]
        xm = M * x
        for a in range(len(coeffs)):
            ax = 1 + a
            for k, shifted in enumerate((lambda: torch.roll(xm, -1, ax), lambda: xm,
                                         lambda: torch.roll(xm, 1, ax))):
                if ctx.needs_input_grad[3 + 3 * a + k]:
                    grads.append(-_reduce_to_axis(mu * shifted(), ax))
                else:
                    grads.append(None)
        return tuple(grads)


class DifferentiableSolve(_Krylov):
    """Differentiable matrix-free Krylov solve ``x = A(coeffs)⁻¹ rhs``.

    Args:
        mesh: the mesh (static masks / grid).
        bcs: the target Field's BC list; every BC must be homogeneous
            (value 0 / valueless) so BC application is linear.
        tol: relative-residual tolerance of the forward and adjoint
            solves.
        max_it: iteration cap.
        symmetric: declare the reduced operator symmetric (CG inner
            solver, the adjoint with the same operator). Default False:
            BiCGSTAB and the analytic-transpose adjoint — correct for any
            axis-vector operator, Neumann-surgered and advective ones too.
    """

    def __init__(self, mesh, bcs, tol: float = 1e-8, max_it: int = 2000,
                 symmetric: bool = False):
        _check_bcs("DifferentiableSolve", bcs,
                   ("dirichlet", "neumann", "symmetry", "periodic"))
        super().__init__(mesh, bcs, tol, max_it, symmetric)

    def __call__(self, coeffs, rhs: torch.Tensor) -> torch.Tensor:
        """Solve ``A(coeffs) x = rhs`` differentiably.

        Args:
            coeffs: per-axis ``(ap, ac, am)`` coefficient vectors of the
                (surgered) operator on the active set (tensors of ``rhs``'s
                dtype and device, or host arrays).
            rhs: ``(vdim, *nx)`` right-hand side.

        Returns the solution with BCs applied; gradients w.r.t. both
        ``coeffs`` and ``rhs`` flow through one adjoint solve.
        """
        flat = []
        for cs in coeffs:
            if len(cs) != 3:
                raise ValueError("DifferentiableSolve: every axis takes (ap, ac, am)")
            flat += [_as_coeff(c, rhs) for c in cs]
        x = _AxisSolve.apply(self, self.mask(rhs), rhs, *flat)
        return self._apply_bcs(x)


def _neumann_rows(surgery):
    """Per mesh axis, the surgered (lower, upper) faces as booleans."""
    return [(lo == "neumann", up == "neumann") for lo, up in surgery]


def diff_field_transpose(y: torch.Tensor, gamma: torch.Tensor, inv_dx2, surgery,
                         avg: str = "arithmetic") -> torch.Tensor:
    """``Dᵀ y`` of the variable-Γ operator ``D = apply_diff_field(·, Γ)``.

    The flux form is symmetric, wrap rows included (``gm[i+1] = gp[i]``):
    that part is the ``diff_field`` wrapper with surgery "none" (the
    kernel on a CUDA tensor). A Neumann row adds ``c0 (4/3 x₁ - 1/3 x₂ -
    x₀)`` on row 1 (``c0 = Γ_{½} / dx²``; the upper face mirrors it on row
    n-2); transposed, ``y₁`` scatters ``4/3 c0 y₁`` to row 1, ``-1/3 c0
    y₁`` to row 2 and ``-c0 y₁`` to the boundary row 0."""
    nd = y.ndim - 1
    out = diff_field(y, gamma, inv_dx2, (("none", "none"),) * nd, avg)
    aniso = gamma.ndim == nd + 1
    cdt = out.dtype
    for j, (lo, up) in enumerate(_neumann_rows(surgery)):
        if not (lo or up):
            continue
        ax = 1 + j
        gj = (gamma[j] if aniso else gamma).to(cdt)
        n = y.shape[ax]
        for on, (row, nxt, bnd, face) in ((lo, (1, 2, 0, 0)), (up, (n - 2, n - 3, n - 1, n - 2))):
            if not on:
                continue
            c0 = _face(gj.select(j, face), gj.select(j, face + 1), avg) * float(inv_dx2[j])
            yr = y.select(ax, row) * c0
            out.select(ax, row).add_(yr, alpha=4.0 / 3.0)
            out.select(ax, nxt).add_(yr, alpha=-1.0 / 3.0)
            out.select(ax, bnd).sub_(yr)
    return out


def diff_field_gamma_vjp(mu: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor, inv_dx2,
                         surgery, avg: str = "arithmetic") -> torch.Tensor:
    """``μᵀ ∂(D(Γ) x)/∂Γ`` shaped like ``gamma`` (isotropic ``nx`` or
    stacked ``(dim, *nx)``).

    Per face (i, i+1) of axis j: ``∂/∂F = (μ_i - μ_{i+1})(x_{i+1} - x_i)
    / dx_j²`` summed over the components, plus a Neumann row's ``μ₁ (4/3
    x₁ - 1/3 x₂ - x₀) / dx²`` on the boundary face (the upper face
    mirrors it); then the face rule's derivative to each side:
    arithmetic ½ and ½, harmonic ``2b²/(a+b)²`` and ``2a²/(a+b)²``."""
    nd = x.ndim - 1
    aniso = gamma.ndim == nd + 1
    parts = []
    for j, (lo, up) in enumerate(_neumann_rows(surgery)):
        ax = 1 + j
        inv = float(inv_dx2[j])
        dF = ((mu - torch.roll(mu, -1, ax)) * (torch.roll(x, -1, ax) - x)).sum(0) * inv
        n = x.shape[ax]
        for on, (row, nxt, bnd, face) in ((lo, (1, 2, 0, 0)), (up, (n - 2, n - 3, n - 1, n - 2))):
            if on:
                row_term = (4.0 / 3.0) * x.select(ax, row) - (1.0 / 3.0) * x.select(ax, nxt) \
                    - x.select(ax, bnd)
                dF.select(j, face).add_((mu.select(ax, row) * row_term).sum(0) * inv)
        a = gamma[j] if aniso else gamma
        b = torch.roll(a, -1, j)
        if avg == "harmonic":
            s2 = (a + b) ** 2
            da, db = 2.0 * b * b / s2, 2.0 * a * a / s2
        else:
            da = db = 0.5
        parts.append(dF * da + torch.roll(dF * db, 1, j))
    return torch.stack(parts) if aniso else sum(parts[1:], parts[0])


class _DiffusionSolve(torch.autograd.Function):
    """``x = (M (shift I + s D(Γ)) M)⁻¹ (M rhs)``; inputs ``(solver, M,
    rhs, gamma, shift, s)``."""

    @staticmethod
    def forward(ctx, solver, M, rhs, gamma, shift, s):
        x = solver._inner(solver._matvec(M, gamma, shift, s, False), M * rhs, "forward")
        ctx.solver, ctx.s, ctx.shift = solver, s, shift
        ctx.save_for_backward(M, x, gamma)
        return x

    @staticmethod
    def backward(ctx, g):
        solver, s = ctx.solver, ctx.s
        M, x, gamma = ctx.saved_tensors
        matvec = solver._matvec(M, gamma, ctx.shift, s, not solver.symmetric)
        lam = solver._inner(matvec, M * g, "adjoint")
        mu = M * lam
        xm = M * x
        need = ctx.needs_input_grad
        g_gamma = None
        if need[3]:
            g_gamma = diff_field_gamma_vjp(mu, xm, gamma, solver._inv_dx2, solver._surgery,
                                           solver.avg) * (-s)
        return None, None, mu if need[2] else None, g_gamma, None, None


class DifferentiableDiffusionSolve(_Krylov):
    """Differentiable heterogeneous-diffusivity solve ``x = A(Γ)⁻¹ rhs``
    for the conservative variable-coefficient Laplacian
    (``ops/stencil.py::apply_diff_field``), the permeability/conductivity
    inversion primitive: gradients of any functional of the solution flow
    to the PER-POINT Γ through one adjoint solve.

    Args:
        mesh: the mesh (static masks / grid; Cartesian, 2-D or 3-D).
        bcs: homogeneous Dirichlet/Neumann/Symmetry BCs (no periodic
            axes at this layer).
        avg: face-transmissibility rule ("arithmetic" | "harmonic"); both
            are differentiable in Γ.
        symmetric: all-Dirichlet operators are exactly SPD (CG inner
            solver, the adjoint with the same operator); default False
            uses BiCGSTAB and the hand-written transpose (required once
            a Neumann face makes the surgered rows nonsymmetric).
    """

    def __init__(self, mesh, bcs, tol: float = 1e-8, max_it: int = 2000,
                 avg: str = "arithmetic", symmetric: bool = False):
        if mesh.coord_sys != "xyz":
            raise ValueError("DifferentiableDiffusionSolve: rz meshes not supported (the "
                             "Cartesian flux form lacks the 1/r metric terms)")
        _check_bcs("DifferentiableDiffusionSolve", bcs, ("dirichlet", "neumann", "symmetry"))
        super().__init__(mesh, bcs, tol, max_it, symmetric)
        self.avg = avg
        self._surgery = div_surgery_info(bcs, mesh.dim)
        self._inv_dx2 = tuple(1.0 / float(d) ** 2 for d in mesh.dx_np)

    def _matvec(self, M, gamma, shift, s, transpose: bool):
        """``v -> M (shift M v + s D(Γ) M v)`` (``Dᵀ`` with
        ``transpose``), through the ``diff_field`` wrapper."""
        def matvec(v):
            vm = M * v
            if transpose:
                d = diff_field_transpose(vm, gamma, self._inv_dx2, self._surgery, self.avg)
            else:
                d = diff_field(vm, gamma, self._inv_dx2, self._surgery, self.avg)
            if shift != 0.0:
                d = torch.add(shift * vm, d, alpha=s)
            elif s != 1.0:
                d = d * s
            return d.mul_(M)
        return matvec

    def __call__(self, gamma: torch.Tensor, rhs: torch.Tensor, shift: float = 0.0,
                 flux_sign: float = 1.0) -> torch.Tensor:
        """Solve ``A(Γ) x = rhs`` differentiably (gradients w.r.t.
        ``gamma`` — isotropic ``nx`` or stacked ``(dim, *nx)`` — and
        ``rhs``).

        ``shift``/``flux_sign`` generalize the operator to ``A = shift I +
        flux_sign div(Γ grad ·)``: an implicit heat step ``(I/dt -
        div(Γ grad)) x = x_old/dt`` is ``shift=1/dt, flux_sign=-1``."""
        x = _DiffusionSolve.apply(self, self.mask(rhs), rhs, gamma.contiguous(), float(shift),
                                  float(flux_sign))
        return self._apply_bcs(x)


def fold_ddt(coeffs, inv_dt):
    """Add the backward-Euler identity ``inv_dt I`` into an axis-vector
    stencil (axis 0's center vector)."""
    (ap0, ac0, am0), *rest = coeffs
    return ((ap0, ac0 + inv_dt, am0), *rest)


def _roll_steps(step, x0: torch.Tensor, n_steps: int, checkpoint: bool) -> torch.Tensor:
    x = x0
    for _ in range(int(n_steps)):
        if checkpoint:
            x = torch.utils.checkpoint.checkpoint(step, x, use_reentrant=False)
        else:
            x = step(x)
    return x


class DifferentiableTransient:
    """N implicit transport steps as one differentiable rollout.

    Each step is backward Euler ``(I/dt + A(θ)) x_{n+1} = x_n / dt +
    source``, ``coeff_fn(θ)`` building the per-axis stencil vectors of
    ``A(θ)`` (gradients flow to ``θ`` through one adjoint solve per step).
    The coefficients are built once per call, so their gradients
    accumulate across the steps back to ``θ``. With ``checkpoint`` each
    step is recomputed in the backward sweep instead of keeping its
    saved tensors.

    Args:
        mesh/bcs: as :class:`DifferentiableSolve` (homogeneous BCs).
        coeff_fn: ``theta -> per-axis (ap, ac, am)`` vectors of ``A``.
        dt: time step.
        symmetric: declare ``I/dt + A`` symmetric (CG inner solver).
        checkpoint: recompute each step in the backward sweep (default
            True).
    """

    def __init__(self, mesh, bcs, coeff_fn, dt: float, tol: float = 1e-10,
                 max_it: int = 2000, symmetric: bool = False, checkpoint: bool = True):
        self._dsolve = DifferentiableSolve(mesh, bcs, tol=tol, max_it=max_it,
                                           symmetric=symmetric)
        self._coeff_fn = coeff_fn
        self.dt = float(dt)
        self.checkpoint = bool(checkpoint)

    def __call__(self, theta, x0: torch.Tensor, n_steps: int, source=0.0) -> torch.Tensor:
        """Roll ``n_steps`` from ``x0``; returns the final state.
        Differentiable w.r.t. ``theta``, ``x0`` and a tensor ``source``."""
        inv_dt = 1.0 / self.dt
        coeffs = tuple(tuple(_as_coeff(c, x0) for c in cs)
                       for cs in fold_ddt(self._coeff_fn(theta), inv_dt))
        return _roll_steps(lambda x: self._dsolve(coeffs, x * inv_dt + source), x0, n_steps,
                           self.checkpoint)


class DifferentiableTransientDiffusion:
    """N implicit heat steps with a PER-POINT diffusivity Γ: each step
    solves ``(I/dt - div(Γ grad)) x_{n+1} = x_n/dt + source``; gradients
    w.r.t. Γ flow through one adjoint solve per step."""

    def __init__(self, mesh, bcs, dt: float, tol: float = 1e-10, max_it: int = 2000,
                 avg: str = "arithmetic", symmetric: bool = False, checkpoint: bool = True):
        self._dsolve = DifferentiableDiffusionSolve(mesh, bcs, tol=tol, max_it=max_it,
                                                    avg=avg, symmetric=symmetric)
        self.dt = float(dt)
        self.checkpoint = bool(checkpoint)

    def __call__(self, gamma, x0: torch.Tensor, n_steps: int, source=0.0) -> torch.Tensor:
        inv_dt = 1.0 / self.dt
        return _roll_steps(
            lambda x: self._dsolve(gamma, x * inv_dt + source, shift=inv_dt, flux_sign=-1.0),
            x0, n_steps, self.checkpoint)
