"""Fast-diagonalization direct solve wrapped in iterative refinement
(port of ``pyapes_tpu/solver/linalg.py::_build_fastdiag``).

Each pass is ``x += FD(b - A x)``: one stencil apply (the same ``Aop`` the
Krylov path uses, so the reported tolerance is the TRUE relative residual)
plus one Kronecker eigen-solve. The JAX ``lax.while_loop`` becomes
``graph_loop.while_loop`` over buffers the loop owns (``x``, ``r``, the
float64 tolerance, ``itr``, the history, the condition), updated in place:
on the host with one read of the condition per pass, or as a WHILE node
under a graph capture. It keeps the JAX loop's three exits: the
tolerance, ``max_it``, and the stall exit at the dtype's accuracy floor.
On a placed decomposition the vectors are block vectors
(``parallel/blocks.py``): the residual is the placed apply, the
eigen-solve ``FastDiag.solve_blocks`` (pencil repartitions between the
blocks' devices), the update a masked whole-block one, and the mean
projection sums per-block partials in block order. Per card
(``graph_loop.per_card``) the loop's scalars are replicated on every card
and the sums combined on each (``blocks.Replicated``).
"""
from __future__ import annotations

import torch

from pyapes_tpu_torch.ops.graph_loop import loop_record, while_loop
from pyapes_tpu_torch.parallel.blocks import BlockTensor, l2_per_dim, replicated


def _l2_per_dim(x: torch.Tensor) -> torch.Tensor:
    if isinstance(x, BlockTensor):  # per-block norms, combined on the lead device
        return l2_per_dim(x)
    return torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1)


def _vsum(x: torch.Tensor) -> torch.Tensor:
    """Per-component sum over the mesh axes, kept broadcastable."""
    return torch.sum(x, dim=tuple(range(1, x.ndim)), keepdim=True)


def loop_state(x: torch.Tensor, max_it: int, go: bool):
    """The scalar state of a solver loop on ``x``'s device: the tolerance
    (float64, 1.0), the iteration count (int64, 0), the convergence history
    (float32, ``max_it`` NaNs, as the JAX loops keep it) and the loop's
    condition (bool, ``go``), which ``graph_loop.loop_record`` updates.
    Per card (``graph_loop.per_card``), each is replicated on every card
    of ``x``'s blocks (``blocks.replicated``)."""
    return (replicated(lambda dev: torch.ones((), dtype=torch.float64, device=dev), x),
            replicated(lambda dev: torch.zeros((), dtype=torch.int64, device=dev), x),
            replicated(lambda dev: torch.full((max_it,), float("nan"), dtype=torch.float32,
                                              device=dev), x),
            replicated(lambda dev: torch.full((), bool(go), dtype=torch.bool, device=dev), x))


def build_fastdiag(
    Aop, apply_bcs, M, tolerance, max_it, fd, act_sel, scalars,
    project_mean=False, null_shift=None,
):
    """Build ``fd_fn(x0, rhs, tparams, bc_vals, donate=False) -> (x, itr,
    tol, hist)`` (device tensors, as ``cg_loop.build_cg``; ``donate``: the
    loop works in ``x0``'s storage, which holds the solution at the end).

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

    def fd_fn(x0, rhs, tparams, bc_vals=(), donate=False):
        M_ = M.build(bc_vals)
        n_act = M_.sum()

        def apply_bcs_(v, inplace=False):
            return apply_bcs(v, bc_vals if bc_vals else None, inplace=inplace)

        def demean(v):
            if not project_mean:
                return v
            return v - (_vsum(v * M_) / n_act) * M_

        def residual(x, out=None):
            # b - A x on the active set; Aop's output is a fresh tensor,
            # so it is overwritten in place (or written into ``out``).
            r = Aop(x, tparams)
            r = torch.sub(rhs, r, out=r if out is None else out)
            r.mul_(M_)
            if project_mean:
                r.sub_((_vsum(r * M_) / n_act) * M_)
            return r

        if project_mean:
            # compatibility shift: subtract the constant that makes the
            # rhs orthogonal to the left null vector ``w``
            if null_shift is not None:
                w = null_shift() * M_
                rhs = rhs * M_ - (_vsum(rhs * w) / torch.sum(w)) * M_
            else:
                rhs = demean(rhs * M_)

        c_ax, c_dt = scalars(tparams)

        # apply_bcs_ returns a new tensor: the in-place updates of ``x``
        # below never write the caller's ``x0`` — unless it was donated
        x = apply_bcs_(x0, inplace=donate)
        r = residual(x)
        r0n = torch.clamp_min(_l2_per_dim(r).max(), torch.finfo(x.dtype).tiny)
        tol, itr, hist, go = loop_state(x, max_it, 1.0 > tolerance and max_it > 0)

        def body():
            if isinstance(r, BlockTensor):  # 0 off the active set: a masked whole-block update
                x.addcmul_(fd.solve_blocks(r, act_sel[1:], c_ax, c_dt, pseudo=project_mean), M_)
            else:
                x[act_sel] += fd.solve(r[act_sel].contiguous(), c_ax, c_dt, pseudo=project_mean)
            if project_mean:
                x.sub_(_vsum(x * M_) / n_act)
            residual(x, out=r)
            # A pass contracts at the one-pass transform accuracy (>=10x
            # in practice); <2x means the dtype's accuracy floor is
            # reached — stop instead of spinning to max_it.
            loop_record(_l2_per_dim(r).max() / r0n, tol, itr, hist, go, max_it, tolerance,
                        stall_ratio=0.5)

        while_loop(lambda: go, body, x.device)
        return apply_bcs_(x, inplace=donate), itr, tol, hist

    return fd_fn
