"""Fast-diagonalization direct solve wrapped in iterative refinement
(port of ``pyapes_tpu/solver/linalg.py::_build_fastdiag``).

Each pass is ``x += FD(b - A x)``: one stencil apply (the same ``Aop`` the
Krylov path uses, so the reported tolerance is the TRUE relative residual)
plus one Kronecker eigen-solve. The JAX ``lax.while_loop`` becomes a
Python loop with ONE device-to-host read per pass (the tolerance), which
decides whether to run another pass. It keeps the JAX loop's three exits:
the tolerance, ``max_it``, and the stall exit at the dtype's accuracy
floor.
"""
from __future__ import annotations

import torch


def _l2_per_dim(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1)


def _vsum(x: torch.Tensor) -> torch.Tensor:
    """Per-component sum over the mesh axes, kept broadcastable."""
    return torch.sum(x, dim=tuple(range(1, x.ndim)), keepdim=True)


def build_fastdiag(
    Aop, apply_bcs, M, tolerance, max_it, fd, act_sel, scalars,
    project_mean=False, null_shift=None,
):
    """Build ``fd_fn(x0, rhs, tparams, bc_vals) -> (x, itr, tol, hist)``.

    Args:
        Aop: operator ``(x, tparams) -> A x`` (fresh tensor).
        apply_bcs: ``(x, bc_vals) -> x`` with the BCs applied (fresh tensor).
        M: ``_MaskSpec`` of the active set.
        fd: ``FastDiag`` factors of the active-set operator.
        act_sel: index of the active set (``(slice(None), *slicer)``).
        scalars: ``tparams -> (c_ax, c_dt)`` of the eigen-symbol.
        project_mean: solve on the zero-mean quotient space (singular
            all-Neumann systems; pseudo-inverse eigen-solve).
        null_shift: deferred constructor of the left null vector's row-scale
            field for eliminated-Neumann systems (``None``: constant).
    """

    def fd_fn(x0, rhs, tparams, bc_vals=()):
        M_ = M.build(bc_vals)
        n_act = M_.sum()

        def apply_bcs_(v):
            return apply_bcs(v, bc_vals if bc_vals else None)

        def demean(v):
            if not project_mean:
                return v
            return v - (_vsum(v * M_) / n_act) * M_

        def residual(x):
            # b - A x on the active set; Aop's output is a fresh tensor,
            # so it is overwritten in place.
            r = Aop(x, tparams)
            torch.sub(rhs, r, out=r)
            return demean(r.mul_(M_))

        if project_mean:
            # compatibility shift: subtract the constant that makes the
            # rhs orthogonal to the left null vector ``w``
            if null_shift is not None:
                w = null_shift() * M_
                rhs = rhs * M_ - (_vsum(rhs * w) / torch.sum(w)) * M_
            else:
                rhs = demean(rhs * M_)

        c_ax, c_dt = scalars(tparams)

        # apply_bcs_ returns a new tensor: the in-place update of ``x``
        # below never writes the caller's ``x0``.
        x = apply_bcs_(x0)
        r = residual(x)
        r0n = torch.clamp_min(_l2_per_dim(r).max(), torch.finfo(x.dtype).tiny)

        tol, itr, hist = 1.0, 0, []
        while tol > tolerance and itr < max_it:
            e = fd.solve(r[act_sel].contiguous(), c_ax, c_dt, pseudo=project_mean)
            x[act_sel] += e  # in place, on this loop's own iterate
            if project_mean:
                x = x - _vsum(x * M_) / n_act
            r = residual(x)
            tol_new = (_l2_per_dim(r).max() / r0n).item()  # the one host read of the pass
            # A pass contracts at the one-pass transform accuracy (>=10x
            # in practice); <2x means the dtype's accuracy floor is
            # reached — stop instead of spinning to max_it.
            stall = tol_new > 0.5 * tol
            hist.append(tol_new)
            tol, itr = tol_new, itr + 1
            if stall:
                break
        return apply_bcs_(x), itr, tol, hist

    return fd_fn
