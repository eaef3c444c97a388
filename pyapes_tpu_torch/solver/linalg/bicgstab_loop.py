"""BiCGSTAB (port of ``pyapes_tpu/solver/linalg.py::_build_bicgstab``).

Right-preconditioned with ``precond`` (the multigrid V-cycle), for
nonsymmetric systems where CG does not apply. The JAX ``lax.while_loop``
becomes a Python loop over device tensors. The JAX ``lax.cond`` on the
mid-iteration early exit needs that tolerance on the host, so an
iteration reads one value back (the early exit) or two (the full step).
As in the JAX package, a residual blow-up past 1e3 times the best
tolerance seen ends the loop (BiCGSTAB breaks down once it reaches its
attainable accuracy), and the best iterate is returned.
"""
from __future__ import annotations

import math

import torch

from pyapes_tpu_torch.solver.linalg.cg_loop import _nan0, _r0_norm
from pyapes_tpu_torch.solver.linalg.fastdiag_loop import _l2_per_dim, _vsum


def build_bicgstab(Aop, apply_bcs, M, tolerance, max_it, criterion, precond=None, fmg_init=None,
                   precond_setup=None):
    """Build ``bicg_fn(x0, rhs, tparams, bc_vals) -> (x, itr, tol, hist)``;
    arguments as ``cg_loop.build_cg``."""

    def bicg_fn(x0, rhs, tparams, bc_vals=()):
        if precond_setup is not None:
            precond_setup(tparams)
        M_ = M.build(bc_vals)

        def apply_bcs_(v):
            return apply_bcs(v, bc_vals if bc_vals else None)

        def P(v):
            return precond(v) * M_ if precond is not None else v

        x = apply_bcs_(x0)
        r0n = None
        if fmg_init is not None:
            # the normalization keeps the PRE-FMG scale (as in CG)
            r_pre = (rhs - Aop(x, tparams)) * M_
            r0n = _r0_norm(r_pre)
            x = apply_bcs_(x + fmg_init(r_pre) * M_)
        r0 = (rhs - Aop(x, tparams)) * M_
        if r0n is None:
            r0n = _r0_norm(r0)
        r = r0
        p = torch.zeros_like(r)
        v = torch.zeros_like(r)
        one = torch.ones((r.shape[0],) + (1,) * (r.ndim - 1), dtype=r.dtype, device=r.device)
        rho, alpha, omega = one, one, one
        rho_next = _vsum(r0 * r0)

        def tol_of(vec):
            t = _l2_per_dim(vec).max()
            return (t if criterion == "delta" else t / r0n).item()

        tol = math.sqrt(rho_next.max().item())
        best_x, best_tol = x, math.inf
        itr, hist = 0, []
        finished = False
        while not finished and itr < max_it:
            beta = _nan0(rho_next / rho * alpha / omega)
            rho = rho_next
            p = r + beta * (p - omega * v)
            p_hat = P(p)
            v = Aop(p_hat, tparams) * M_
            alpha = _nan0(rho / _vsum(r0 * v))
            s_vec = r - alpha * v
            tol1 = tol_of(s_vec)
            if tol1 <= tolerance:
                # early exit; BCs are applied at loop exit
                x = x + alpha * p_hat
                r, rho_next, tol, finished = s_vec, rho, tol1, True
            else:
                s_hat = P(s_vec)
                t = Aop(s_hat, tparams) * M_
                omega = _nan0(_vsum(t * s_vec) / _vsum(t * t))
                rho_next = -omega * _vsum(r0 * t)
                x = x + alpha * p_hat + omega * s_hat
                r = s_vec - omega * t
                tol = tol_of(r)
                finished = tol <= tolerance or tol > 1e3 * min(best_tol, tol)
            if tol < best_tol:
                best_x, best_tol = x, tol
            hist.append(tol)
            itr += 1
        if best_tol < tol:
            x, tol = best_x, best_tol
        return apply_bcs_(x), itr, tol, hist

    return bicg_fn
