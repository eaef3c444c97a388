"""BiCGSTAB (port of ``pyapes_tpu/solver/linalg.py::_build_bicgstab``).

Right-preconditioned with ``precond`` (the multigrid V-cycle), for
nonsymmetric systems where CG does not apply. The JAX ``lax.while_loop``
becomes ``graph_loop.while_loop`` over buffers the loop owns, updated in
place. The JAX ``lax.cond`` on the mid-iteration early exit becomes a
select: both branches run and the early one's values are taken where its
test holds (``torch.where``, the same bits as a branch), so an iteration
reads nothing back to the host, eager or captured; the price is one
preconditioner and operator apply whose result is dropped, on the last
iteration of a solve that exits early. As in the JAX package, a residual
blow-up past 1e3 times the best tolerance seen ends the loop (BiCGSTAB
breaks down once it reaches its attainable accuracy), and the best iterate
is returned. Tolerances are held in float64, as the host compared them.
Under a placed decomposition the same loop runs on block vectors, as CG's
(``cg_loop.py``).
"""
from __future__ import annotations

import torch

from pyapes_tpu_torch.ops.graph_loop import loop_record, while_loop
from pyapes_tpu_torch.solver.linalg.cg_loop import _nan0, _r0_norm
from pyapes_tpu_torch.solver.linalg.fastdiag_loop import _l2_per_dim, _vsum, loop_state


def build_bicgstab(Aop, apply_bcs, M, tolerance, max_it, criterion, precond=None, fmg_init=None,
                   precond_setup=None):
    """Build ``bicg_fn(x0, rhs, tparams, bc_vals, donate=False) -> (x, itr,
    tol, hist)``; arguments and results as ``cg_loop.build_cg``."""

    def bicg_fn(x0, rhs, tparams, bc_vals=(), donate=False):
        M_ = M.build(bc_vals)

        def apply_bcs_(v, inplace=False):
            return apply_bcs(v, bc_vals if bc_vals else None, inplace=inplace)

        def P(v):
            return precond(v) * M_ if precond is not None else v

        x = apply_bcs_(x0, inplace=donate)
        r0 = (rhs - Aop(x, tparams)) * M_
        r0n = _r0_norm(r0)
        if precond_setup is not None:  # after the operator's first apply, as in CG
            precond_setup(tparams)
        if fmg_init is not None:
            # the normalization keeps the PRE-FMG scale (as in CG)
            dx = fmg_init(r0) * M_
            x = apply_bcs_(x.add_(dx) if donate else x + dx, inplace=donate)
            r0 = (rhs - Aop(x, tparams)) * M_
        r = r0.clone()
        p = torch.zeros_like(r)
        v = torch.zeros_like(r)
        rho_next = _vsum(r0 * r0)
        # (vdim, 1, ..., 1) ones where rho_next lives (on every card, per card)
        one = torch.ones_like(rho_next)
        rho, alpha, omega = one.clone(), one.clone(), one.clone()
        tol, itr, hist, go = loop_state(x, max_it, max_it > 0)
        tol.copy_(torch.sqrt(rho_next.max().double()))
        best_x, best_tol = x.clone(), torch.full_like(tol, float("inf"))
        finished = torch.zeros_like(go)

        def tol_of(vec):
            t = _l2_per_dim(vec).max()
            return (t if criterion == "delta" else t / r0n).double()

        def body():
            beta = _nan0(rho_next / rho * alpha / omega)
            rho.copy_(rho_next)
            torch.add(r, beta * (p - omega * v), out=p)
            p_hat = P(p)
            torch.mul(Aop(p_hat, tparams), M_, out=v)
            alpha.copy_(_nan0(rho / _vsum(r0 * v)))
            s_vec = r - alpha * v
            tol1 = tol_of(s_vec)
            early = tol1 <= tolerance  # the early exit; BCs are applied at loop exit
            x_early = x + alpha * p_hat
            s_hat = P(s_vec)
            t = Aop(s_hat, tparams) * M_
            omega_new = _nan0(_vsum(t * s_vec) / _vsum(t * t))
            r_full = s_vec - omega_new * t
            tol2 = tol_of(r_full)
            done = torch.logical_or(tol2 <= tolerance,
                                    tol2 > 1e3 * torch.minimum(best_tol, tol2))
            torch.where(early, x_early, x_early + omega_new * s_hat, out=x)
            torch.where(early, s_vec, r_full, out=r)
            torch.where(early, rho, -omega_new * _vsum(r0 * t), out=rho_next)
            torch.where(early, tol1, tol2, out=tol)
            torch.logical_or(early, done, out=finished)
            torch.where(early, omega, omega_new, out=omega)
            better = tol < best_tol
            torch.where(better, x, best_x, out=best_x)
            torch.where(better, tol, best_tol, out=best_tol)
            loop_record(tol, tol, itr, hist, go, max_it, stop=finished)

        while_loop(lambda: go, body, x.device)
        use_best = best_tol < tol
        x_out = torch.where(use_best, best_x, x, out=x if donate else None)
        return apply_bcs_(x_out, inplace=donate), itr, torch.minimum(best_tol, tol), hist

    return bicg_fn
