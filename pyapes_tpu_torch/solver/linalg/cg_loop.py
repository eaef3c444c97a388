"""(Preconditioned) conjugate gradient (port of
``pyapes_tpu/solver/linalg.py::_build_cg``).

The JAX ``lax.while_loop`` becomes ``graph_loop.while_loop`` over state
buffers the loop owns (``x``, ``r``, ``d``, ``rz``, ``tol``, ``itr`` and
the NaN-padded history), which the body updates in place: on the host (one
read of the condition per iteration) or, under a graph capture, as a WHILE
node whose exit the device decides. ``alpha``, ``beta`` and ``rz`` are
device tensors (``_nan0`` is ``torch.nan_to_num``); the tolerance is held
in float64, as the host compared it. With the multigrid preconditioner
this is MG-PCG; ``precond_dot`` fuses ``dot(r, z)`` into the V-cycle's last
smooth and ``Aop_dot`` fuses ``dot(d, A d)`` into the stencil apply. BCs
are applied on entry and at exit only: every search direction is
interior-masked, so boundary values are invariant and unread inside the
loop. Under a placed decomposition the vectors are block vectors
(``parallel/blocks.py``) and the same loop runs on them: each operation
block by block on each block's device, the dots summed from per-block
partials on the lead device (where ``loop_state`` lives and the stop
test's one read per iteration happens).
"""
from __future__ import annotations

import torch

from pyapes_tpu_torch.ops.graph_loop import loop_record, while_loop
from pyapes_tpu_torch.solver.linalg.fastdiag_loop import _l2_per_dim, _vsum, loop_state


def _nan0(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _r0_norm(r: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(_l2_per_dim(r).max(), torch.finfo(r.dtype).tiny)


def build_cg(
    Aop, apply_bcs, M, tolerance, max_it, criterion, precond=None,
    project_mean=False, Aop_dot=None, fmg_init=None, precond_dot=None,
    null_shift=None, precond_setup=None,
):
    """Build ``cg_fn(x0, rhs, tparams, bc_vals, donate=False) -> (x, itr,
    tol, hist)``: ``itr`` (int64), ``tol`` (float64) 0-d and ``hist``
    (float32, ``max_it`` entries, NaN past ``itr``) device tensors;
    ``donate``: the iterate lives in ``x0``'s storage, which holds the
    solution at the end.

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
        precond_setup: ``tparams -> None``, run once per call after the
            initial residual, before the FMG start and the loop (streams a
            variable-Γ term's Γ into the V-cycle hierarchy; device work
            only, which the operator never reads), or None.
    """

    def cg_fn(x0, rhs, tparams, bc_vals=(), donate=False):
        M_ = M.build(bc_vals)
        n_act = M_.sum()

        def apply_bcs_(v, inplace=False):
            return apply_bcs(v, bc_vals if bc_vals else None, inplace=inplace)

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

        x = apply_bcs_(x0, inplace=donate)
        r_pre = (rhs - Aop(x, tparams)) * M_
        if precond_setup is not None:
            precond_setup(tparams)
        if fmg_init is not None:
            # the relative-residual normalization keeps the PRE-FMG scale,
            # so the FMG reduction counts toward the tolerance
            r0n = _r0_norm(r_pre)
            dx = fmg_init(r_pre) * M_
            x = apply_bcs_(x.add_(dx) if donate else x + dx, inplace=donate)
            r = demean((rhs - Aop(x, tparams)) * M_)
        else:
            r = demean(r_pre)
            r0n = _r0_norm(r)

        def pz(r):
            if precond_dot is not None:
                # the V-cycle output is already interior-masked
                return precond_dot(r)
            z = precond(r) * M_ if precond is not None else r
            return z, _vsum(r * z)

        z, rz = pz(r)
        d = z.clone()  # owned: z may be r itself
        rz = rz.clone()
        aop_dot = Aop_dot(tparams) if Aop_dot is not None else None
        tol, itr, hist, go = loop_state(x, max_it, 1.0 > tolerance and max_it > 0)
        in_place_x = criterion != "delta" and not project_mean

        def body():
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
            # scalar), in place on the loop's buffers: x + alpha d,
            # r - alpha Ad, z + beta d
            if in_place_x:
                torch.addcmul(x, alpha, d, out=x)
            else:
                x_new = torch.addcmul(x, alpha, d)
                if project_mean:
                    x_new = x_new - _vsum(x_new * M_) / n_act
            torch.addcmul(r, alpha, Ad, value=-1.0, out=r)
            if project_mean:
                r.sub_((_vsum(r * M_) / n_act) * M_)
            if criterion == "delta":
                tol_dev = _l2_per_dim(x_new - x).max()
            else:
                tol_dev = _l2_per_dim(r).max() / r0n
            if not in_place_x:
                x.copy_(x_new)
            z, rz_new = pz(r)
            beta = _nan0(rz_new / rz)
            torch.addcmul(z, beta, d, out=d)
            rz.copy_(rz_new)
            loop_record(tol_dev, tol, itr, hist, go, max_it, tolerance)

        while_loop(lambda: go, body, x.device)
        return apply_bcs_(x, inplace=donate), itr, tol, hist

    return cg_fn
