"""(Preconditioned) conjugate gradient (port of
``pyapes_tpu/solver/linalg.py::_build_cg``).

The JAX ``lax.while_loop`` becomes a Python loop whose state stays on the
device: ``alpha``, ``beta`` and ``rz`` are device tensors (``_nan0`` is
``torch.nan_to_num``), and each iteration makes ONE device-to-host read,
the convergence measure, which decides whether to run another. With the
multigrid preconditioner this is MG-PCG; ``precond_dot`` fuses ``dot(r,
z)`` into the V-cycle's last smooth and ``Aop_dot`` fuses ``dot(d, A d)``
into the stencil apply. BCs are applied on entry and at exit only: every
search direction is interior-masked, so boundary values are invariant and
unread inside the loop.
"""
from __future__ import annotations

import torch

from pyapes_tpu_torch.solver.linalg.fastdiag_loop import _l2_per_dim, _vsum


def _nan0(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _r0_norm(r: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(_l2_per_dim(r).max(), torch.finfo(r.dtype).tiny)


def build_cg(
    Aop, apply_bcs, M, tolerance, max_it, criterion, precond=None,
    project_mean=False, Aop_dot=None, fmg_init=None, precond_dot=None,
    null_shift=None,
):
    """Build ``cg_fn(x0, rhs, tparams, bc_vals) -> (x, itr, tol, hist)``.

    Args:
        Aop: ``(x, tparams) -> A x`` (fresh tensor).
        apply_bcs: ``(x, bc_vals) -> x`` with the BCs applied (fresh).
        M: ``_MaskSpec`` of the active set.
        criterion: ``"residual"`` (recursive residual over the initial
            one) or ``"delta"`` (norm of the iterate update).
        precond: ``z = P(r)``, or None for plain CG.
        project_mean: solve on the zero-mean quotient space (singular
            all-Neumann systems).
        Aop_dot: ``tparams -> (d -> (A d, sum(d * A d)))``, or None.
        fmg_init: full-multigrid initial guess ``dx = F(r0)``, or None.
        precond_dot: ``r -> (P(r), sum(r * P(r)))``, or None.
        null_shift: deferred left-null-vector row-scale field for the
            row-scaled eliminated-Neumann system (None: constant).
    """

    def cg_fn(x0, rhs, tparams, bc_vals=()):
        M_ = M.build()
        n_act = M_.sum()

        def apply_bcs_(v):
            return apply_bcs(v, bc_vals if bc_vals else None)

        def demean(v):
            if not project_mean:
                return v
            return v - (_vsum(v * M_) / n_act) * M_

        # Compatibility shift of the (row-scaled) RHS against the left null
        # vector w = D 1 (see the JAX builder for the derivation).
        if project_mean:
            if null_shift is not None:
                w = null_shift() * M_
                rhs = rhs * M_ - (_vsum(rhs * M_) / torch.sum(w)) * w
            else:
                rhs = demean(rhs * M_)

        x = apply_bcs_(x0)
        if fmg_init is not None:
            # the relative-residual normalization keeps the PRE-FMG scale,
            # so the FMG reduction counts toward the tolerance
            r_pre = (rhs - Aop(x, tparams)) * M_
            r0n = _r0_norm(r_pre)
            x = apply_bcs_(x + fmg_init(r_pre) * M_)
            r = demean((rhs - Aop(x, tparams)) * M_)
        else:
            r = demean((rhs - Aop(x, tparams)) * M_)
            r0n = _r0_norm(r)

        def pz(r):
            if precond_dot is not None:
                # the V-cycle output is already interior-masked
                return precond_dot(r)
            z = precond(r) * M_ if precond is not None else r
            return z, _vsum(r * z)

        z, rz = pz(r)
        d = z
        aop_dot = Aop_dot(tparams) if Aop_dot is not None else None
        tol, itr, hist = 1.0, 0, []
        while tol > tolerance and itr < max_it:
            if aop_dot is not None:
                # d is masked, so the dot over the unmasked A d equals
                # dot(d, M A d) exactly
                Ad, dAd = aop_dot(d)
                Ad = Ad * M_
            else:
                Ad = Aop(d, tparams) * M_
                dAd = _vsum(d * Ad)
            alpha = _nan0(rz / dAd)
            # the axpys as single passes (addcmul broadcasts the device
            # scalar): x + alpha d, r - alpha Ad, z + beta d
            x_new = torch.addcmul(x, alpha, d)
            if project_mean:
                x_new = x_new - _vsum(x_new * M_) / n_act
            r = demean(torch.addcmul(r, alpha, Ad, value=-1.0))
            if criterion == "delta":
                tol_dev = _l2_per_dim(x_new - x).max()
            else:
                tol_dev = _l2_per_dim(r).max() / r0n
            x = x_new
            z, rz_new = pz(r)
            beta = _nan0(rz_new / rz)
            d = torch.addcmul(z, beta, d)
            rz = rz_new
            tol = tol_dev.item()  # the one host read of the iteration
            hist.append(tol)
            itr += 1
        return apply_bcs_(x), itr, tol, hist

    return cg_fn
