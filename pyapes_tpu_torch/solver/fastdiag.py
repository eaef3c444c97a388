"""Fast-diagonalization DIRECT solver for separable implicit operators
(PyTorch port of ``pyapes_tpu/solver/fastdiag.py``).

The operators solved here are Kronecker sums of per-axis tridiagonal
matrices, ``A = c_ax * sum_j I (x) T_j (x) I + c_dt * I``, with ``T_j``
built from the per-axis coefficient vectors. Lynch, Rice & Thomas (1964):
eigendecompose each ``T_j = G_j diag(lam_j) F_j`` once on the host (n x n,
float64), then every solve is one dense ``n x n`` transform per axis, a
pointwise divide by the eigen-symbol, and the inverse transforms:

    x = (x)_j G_j  *  1 / (c_ax * sum_j lam_j + c_dt)  *  (x)_j F_j b

Neumann/Symmetry boundary-node elimination makes ``T_j`` nonsymmetric,
but a tridiagonal with same-sign off-diagonal pairs is diagonally similar
to a symmetric matrix: ``eigh`` on the symmetrized matrix gives an
orthogonal basis and real eigenvalues; the similarity folds into the
factors (``F = Q^T D``, ``G = D^{-1} Q``). Singular (all-Neumann) systems
zero the null mode in eigenspace (pseudo-inverse).

Accuracy: by default the transforms run in true float32 — a TF32 (or, on
the TPU, bf16-pass) product loses about four orders of one-pass accuracy.
``backend.set_full_precision_matmul`` pins that for the process whenever a
device is resolved. ``fd_opts`` trades it for speed: ``precision:
"default"`` runs the transforms' GEMMs in TF32 on the card (the flags set
only around them and restored afterwards), ``dtype`` stores the factors in
a narrower type (e.g. bf16); the refinement loop around the solve then
takes more passes to the same tolerance. The factors and eigenvalues are
computed with exactly the JAX package's numpy code, so both packages hold
bit-equal factors.
"""
from __future__ import annotations

import numpy as np
import torch


def axis_matrix_np(ap, ac, am, active: slice, periodic: bool) -> np.ndarray:
    """Dense per-axis operator on the ACTIVE index set (float64).

    Args:
        ap/ac/am: per-axis coefficient vectors (+1 / 0 / -1 offsets).
        active: the axis' active-row slice (``boundary_slicer``).
        periodic: reduced torus axis — the stencil wraps (circulant).
    """
    ap = np.asarray(ap, dtype=np.float64)
    ac = np.asarray(ac, dtype=np.float64)
    am = np.asarray(am, dtype=np.float64)
    idx = np.arange(ap.shape[0])[active]
    n = idx.shape[0]
    A = np.zeros((n, n))
    A[np.arange(n), np.arange(n)] = ac[idx]
    # couplings that leave the active set are dropped — their
    # (fixed-boundary-value) contribution enters through the residual
    A[np.arange(n - 1), np.arange(1, n)] = ap[idx[:-1]]
    A[np.arange(1, n), np.arange(n - 1)] = am[idx[1:]]
    if periodic:
        A[n - 1, 0] = ap[idx[-1]]
        A[0, n - 1] = am[idx[0]]
    return A


def _symmetrize_similarity(A: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Diagonal ``d`` with ``diag(d) A diag(1/d)`` symmetric, and that
    symmetric matrix. Raises ValueError if no real diagonal similarity
    exists (mixed-sign off-diagonal pairs, e.g. a pure-advection axis)."""
    if np.allclose(A, A.T, rtol=0, atol=1e-14 * max(1.0, np.abs(A).max())):
        return np.ones(A.shape[0]), (A + A.T) / 2.0
    n = A.shape[0]
    if n > 1 and (A[0, n - 1] != 0.0 or A[n - 1, 0] != 0.0):
        raise ValueError(
            "fastdiag: nonsymmetric circulant axis operator is not "
            "diagonally symmetrizable"
        )
    d = np.ones(n)
    for i in range(n - 1):
        lo, up = A[i + 1, i], A[i, i + 1]
        if lo == 0.0 and up == 0.0:
            d[i + 1] = d[i]
            continue
        if lo * up <= 0.0:
            raise ValueError(
                "fastdiag: axis operator has a mixed-sign off-diagonal "
                "pair (not diagonally symmetrizable; e.g. an advection "
                "term) — use cg/bicgstab for this equation"
            )
        # (d_{i+1}/d_i)^2 = up/lo makes S[i,i+1] == S[i+1,i]
        d[i + 1] = d[i] * np.sqrt(up / lo)
    S = d[:, None] * A / d[None, :]
    asym = np.abs(S - S.T).max()
    if asym > 1e-12 * max(1.0, np.abs(S).max()):
        raise ValueError(
            "fastdiag: diagonal similarity failed to symmetrize the axis "
            f"operator (residual asymmetry {asym:.2e}) — use cg/bicgstab"
        )
    return d, (S + S.T) / 2.0


FD_PRECISIONS = ("highest", "default")
_FD_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def fd_options(fd_opts) -> tuple[str, torch.dtype | None]:
    """``(precision, transform dtype)`` of a config's ``fd_opts``:
    ``precision`` "highest" (true-f32 transforms, the default) or
    "default" (TF32 transforms on the card), ``dtype`` the factors' dtype
    ("bfloat16" or "float32", as a name or a ``torch.dtype``; None: the
    solve's). Raises ValueError on anything else."""
    opts = dict(fd_opts or {})
    precision = opts.pop("precision", "highest")
    tdt = opts.pop("dtype", None)
    if opts:
        raise ValueError(f"fd_opts: unknown keys {sorted(opts)}; accepted: 'precision', 'dtype'")
    if precision not in FD_PRECISIONS:
        raise ValueError(f"fd_opts: precision must be 'highest' or 'default', got {precision!r}")
    if tdt is not None:
        name = str(tdt).removeprefix("torch.")
        if name not in _FD_DTYPES:
            raise ValueError(f"fd_opts: dtype must be one of {sorted(_FD_DTYPES)}, got {tdt!r}")
        tdt = _FD_DTYPES[name]
    return precision, tdt


class FastDiag:
    """Per-axis eigenfactors + the Kronecker solve.

    Args:
        axis_mats: per mesh axis, the dense float64 active-set operator
            (``axis_matrix_np``).
        dtype: solution dtype (torch); eigenvalues and the symbol divide
            run in it.
        device: where the factors live.
        transform_dtype: dtype of the dense transform factors (None: the
            solution's). With narrower factors (e.g. bf16) each transform
            stage is a product in that dtype accumulated in float32
            (float64 for a float64 solve) and rounded to it between stages;
            the symbol divide and the result are in the solution dtype (the
            JAX package's ``_transform``).
        precision: "highest" (true-f32 products, ~1e-6 per pass) or
            "default": TF32 products on the card (10-bit mantissa inputs,
            f32 accumulation: ~1e-3 per pass at the tensor cores' rate),
            scoped to the transforms; the CPU has no TF32, so there it
            computes the bits of "highest" (as the JAX package's CPU backend
            ignores the precision of an f32 dot).
    """

    def __init__(self, axis_mats, dtype: torch.dtype, device, transform_dtype=None,
                 precision: str = "highest"):
        from pyapes_tpu_torch.backend import np_dtype

        if precision not in FD_PRECISIONS:
            raise ValueError(f"fd_opts: precision must be 'highest' or 'default', got "
                             f"{precision!r}")
        tdt = transform_dtype or dtype
        self.precision = precision
        self.acc = torch.float64 if dtype == torch.float64 else torch.float32
        ndt = np_dtype(dtype)
        self.fwd = []   # F_j = Q^T diag(d)
        self.inv = []   # G_j = diag(1/d) Q
        self.lams = []  # eigenvalues
        lam_np = []
        for A in axis_mats:
            d, S = _symmetrize_similarity(A)
            lam, Q = np.linalg.eigh(S)
            self.fwd.append(self._dev(np.asarray(Q.T * d[None, :], dtype=np_dtype(tdt)), tdt,
                                      device))
            self.inv.append(self._dev(np.asarray(Q / d[:, None], dtype=np_dtype(tdt)), tdt,
                                      device))
            self.lams.append(self._dev(np.asarray(lam, dtype=ndt), dtype, device))
            lam_np.append(lam)
        # scale of the symbol, for the singular-mode cut
        self.lam_scale = float(sum(np.abs(l).max() for l in lam_np))
        self.ndim = len(axis_mats)
        self._embedded: dict = {}

    @staticmethod
    def _dev(a: np.ndarray, dtype, device) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` in the factors' dtype. A float32/float64 product is a
        plain GEMM. A narrower one accumulates in float32 (float64 for a
        float64 solve) and is rounded to the factors' dtype once: on the
        card for a float32 solve the bf16 GEMM itself (cuBLAS
        accumulates in f32; ``transform_matmul`` turns off its
        reduced-precision split-K); else the operands are widened and
        multiplied in the wide type — bf16 products are exact in f32, so on
        the CPU this is the card's arithmetic up to the order of the sums
        (torch's own bf16 CPU matmul would round in its own way)."""
        if a.dtype in (torch.float32, torch.float64) or (
                b.device.type == "cuda" and self.acc == torch.float32):
            return torch.matmul(a, b)
        return torch.matmul(a.to(self.acc), b.to(self.acc)).to(a.dtype)

    def _along(self, F: torch.Tensor, x: torch.Tensor, j: int) -> torch.Tensor:
        """Contract mesh axis j of ``x`` (``(vdim, *shape)``, contiguous, in
        the factors' dtype; axis j whole) with ``F``: one plain GEMM over a
        view, no transpose copy.

        * first axis: ``F @ x.view(vdim, n0, -1)`` (F broadcast over vdim);
        * middle axis: batched ``F @ x.view(-1, n1, n2)``;
        * last axis: ``x.view(-1, n_last) @ F.T``.
        """
        shape = x.shape
        if j == x.dim() - 2:
            return self._mm(x.reshape(-1, shape[-1]), F.T).view(shape)
        if j == 0:
            return self._mm(F, x.view(shape[0], shape[1], -1)).view(shape)
        return self._mm(F, x.view(-1, shape[2], shape[3])).view(shape)  # middle of 3-D

    def _scope(self, devices, mats):
        """The transforms' matmul flags (``backend.transform_matmul``):
        TF32 for ``precision`` "default" and f32-accumulated bf16 for
        narrow factors, where a block lies on the card."""
        from pyapes_tpu_torch.backend import transform_matmul

        cuda = any(torch.device(d).type == "cuda" for d in devices)
        narrow = mats[0].dtype not in (torch.float32, torch.float64)
        return transform_matmul(tf32=self.precision == "default" and cuda,
                                bf16_f32_accumulate=narrow and cuda)

    def _transform(self, mats, x: torch.Tensor) -> torch.Tensor:
        """Contract every mesh axis j of ``x`` (``(vdim, *shape)``,
        contiguous, in the factors' dtype) with ``mats[j]`` (``_along``)."""
        with self._scope((x.device,), mats):
            for j, F in enumerate(mats):
                x = self._along(F, x, j)
        return x

    def _symbol(self, lams, c_ax, c_dt):
        """``c_ax * sum_j lams[j] + c_dt`` broadcast over the axes, formed
        at run time from the per-axis vectors."""
        lam = lams[0].reshape((-1,) + (1,) * (self.ndim - 1))
        for j in range(1, self.ndim):
            shape = [1] * self.ndim
            shape[j] = -1
            lam = lam + lams[j].reshape(shape)
        return c_ax * lam + c_dt

    def _divide(self, y, sym, c_ax, pseudo: bool):
        """``y / sym``; ``pseudo``: the (near-)null modes zeroed instead."""
        if pseudo:
            cut = 1e-10 * self.lam_scale * abs(float(c_ax))
            safe = torch.where(sym == 0, torch.ones_like(sym), sym)
            inv = torch.where(sym.abs() <= cut, torch.zeros_like(sym), 1.0 / safe)
            return y * inv[None]
        return y / sym[None]

    def solve(self, r: torch.Tensor, c_ax, c_dt=0.0, pseudo: bool = False) -> torch.Tensor:
        """``(c_ax * sum_j T_j + c_dt I)^{-1} r`` on the active set.

        ``r``: ``(vdim, *active_shape)``, contiguous. ``pseudo=True`` zeroes
        (near-)null modes of the symbol — the quotient-space solve for
        singular all-Neumann systems. The result is in ``r``'s dtype.
        """
        dt_in = r.dtype
        tdt = self.fwd[0].dtype
        y = self._transform(self.fwd, r.to(tdt)).to(dt_in)
        y = self._divide(y, self._symbol(self.lams, c_ax, c_dt), c_ax, pseudo)
        return self._transform(self.inv, y.to(tdt)).to(dt_in)

    def embedded(self, slicer, nodes) -> tuple:
        """``(fwd, inv, lams, active)``, per mesh axis, on the whole node
        axis of ``nodes`` nodes: the factors in the rows and columns of the
        active range ``slicer[j]`` and the identity elsewhere, the
        eigenvalues there and 0 elsewhere, and the active range as a bool
        vector. A residual that is 0 off the active set transforms to the
        active-set solve's values there and to 0 elsewhere, so every block
        of a placed solve has the whole axis and a pencil divides on node
        counts. Made once per active set, on the factors' device."""
        key = tuple(s.indices(n) for s, n in zip(slicer, nodes))
        if key not in self._embedded:
            out = ([], [], [], [])
            for j, (s, n) in enumerate(zip(slicer, nodes)):
                act = slice(*s.indices(n)[:2])
                for dst, src in ((out[0], self.fwd[j]), (out[1], self.inv[j])):
                    m = torch.eye(n, dtype=src.dtype, device=src.device)
                    m[act, act] = src
                    dst.append(m)
                lam = torch.zeros(n, dtype=self.lams[j].dtype, device=self.lams[j].device)
                lam[act] = self.lams[j]
                out[2].append(lam)
                on = torch.zeros(n, dtype=torch.bool, device=lam.device)
                on[act] = True
                out[3].append(on)
            self._embedded[key] = tuple(tuple(v) for v in out)
        return self._embedded[key]

    def place(self, slicer, lay) -> dict:
        """``{device: embedded fwd + inv + lams + active}`` for the devices
        of the placed layout ``lay`` (``device_cache.device_copies``: made
        once, then the same tensors), its pencils checked
        (``NotImplementedError`` where one cannot divide). The solve's
        build calls it, so no loop makes them."""
        from pyapes_tpu_torch.utils.device_cache import device_copies

        lay.pencils()
        fwd, inv, lams, act = self.embedded(slicer, lay.grid)
        return device_copies(fwd + inv + lams + act, lay.devices)

    def solve_blocks(self, r, slicer, c_ax, c_dt=0.0, pseudo: bool = False):
        """``solve`` of a block vector ``r`` (``blocks.BlockTensor``, 0 off
        the active set ``slicer``) on its blocks' devices, with the
        ``embedded`` factors on each block's device (``place``): per mesh
        axis, in the order of ``Layout.pencils``, the blocks moved to the
        pencil in which that axis is whole (``blocks.move_parts``) and each
        block's GEMM run on its device (the forms of ``_along``); the
        symbol divide per block from its slices of the per-axis eigenvalues
        (1 off the active set; the global symbol is never formed); the
        inverse transforms in the reverse order, back to ``r``'s layout.
        Returns the block vector of the solution on the active set and 0
        elsewhere."""
        from pyapes_tpu_torch.parallel.blocks import BlockTensor, move_parts

        lay, nd = r.placement, self.ndim
        per = self.place(slicer, lay)
        dt_in, tdt = r.dtype, self.fwd[0].dtype
        plan, cur = lay.pencils(), lay
        parts = [p.to(tdt).contiguous() for p in r.parts]

        def run(steps, k):
            nonlocal parts, cur
            with self._scope(lay.devices, self.fwd):
                for a, pen in steps:
                    if pen is not cur:
                        parts = move_parts(parts, cur, pen, r.shape)
                        cur = pen
                    for b, (_, _, dev) in enumerate(cur.blocks):
                        parts[b] = self._along(per[dev][k * nd + a], parts[b], a)

        run(plan, 0)
        for b, (_, sl, dev) in enumerate(cur.blocks):
            c = per[dev]
            sym = self._symbol([c[2 * nd + j][sl[j]] for j in range(nd)], c_ax, c_dt)
            if not pseudo:  # 0 / 1 off the active set
                on = c[3 * nd][sl[0]].reshape((-1,) + (1,) * (nd - 1))
                for j in range(1, nd):
                    on = on & c[3 * nd + j][sl[j]].reshape([-1 if k == j else 1
                                                             for k in range(nd)])
                sym = torch.where(on, sym, 1.0)
            parts[b] = self._divide(parts[b].to(dt_in), sym, c_ax, pseudo).to(tdt)
        run(plan[::-1], 1)
        if cur is not lay:
            parts = move_parts(parts, cur, lay, r.shape)
        return BlockTensor([p.to(dt_in) for p in parts], lay, r.shape)


class FDPrecond:
    """Fast-diagonalization PRECONDITIONER of the Krylov loops (the JAX
    package's ``FDPrecond``): the same eigen-solve as the direct method,
    applied to the residual's active set, ``z = (c_ax sum_j T_j + c_dt
    I)^{-1} r``. The equation scalars (``c_ax``, ``c_dt = 1/dt``) are
    staged per solve call through ``set_scalars`` (the Krylov loops'
    ``precond_setup`` hook), so a new ``dt`` or coefficient is used at once
    and never re-factorizes.

    ``pre_scale``: the CG row scale's inverse ``1/D`` on the active set
    (``(1, *active)``; on a placed solve a block vector ``(1, *grid)``), or
    None: the CG loop solves ``D A x = D b``, whose inverse is ``A^{-1}
    D^{-1}``. A block vector ``r`` (a placed solve) goes whole to
    ``FastDiag.solve_blocks``, no view taken."""

    def __init__(self, fd: FastDiag, act_sel, pseudo: bool = False, pre_scale=None):
        self.fd = fd
        self.act_sel = act_sel
        self.pseudo = pseudo
        self.pre_scale = pre_scale
        self.c_ax = 1.0
        self.c_dt = 0.0

    def set_scalars(self, c_ax, c_dt) -> None:
        self.c_ax = c_ax
        self.c_dt = c_dt

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        from pyapes_tpu_torch.parallel.blocks import BlockTensor

        if isinstance(r, BlockTensor):  # a placed solve: whole blocks, 0 off the active set
            ra = r if self.pre_scale is None else r * self.pre_scale
            return self.fd.solve_blocks(ra, self.act_sel[1:], self.c_ax, self.c_dt,
                                        pseudo=self.pseudo)
        ra = r[self.act_sel]
        if self.pre_scale is not None:
            ra = ra * self.pre_scale
        e = self.fd.solve(ra.contiguous(), self.c_ax, self.c_dt, pseudo=self.pseudo)
        z = torch.zeros_like(r)
        z[self.act_sel] = e
        return z
