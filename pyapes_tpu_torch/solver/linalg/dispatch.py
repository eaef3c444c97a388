"""Linear-solve dispatch (port of ``pyapes_tpu/solver/linalg.py::solve``):
term records -> descriptors and per-call params, method resolution, the
content-keyed cache of eigen-factors, and the report.

Ported: ``method`` ``"fastdiag"``, ``"cg"`` and ``"bicgstab"`` (so the
``fd_fallback`` of a non-separable equation resolves to a working
method), with ``precond`` ``"mg"`` (the multigrid V-cycle, ``mg_opts``) or
None, on Cartesian grids with Dirichlet, Neumann and Symmetry faces, for
the constant-coefficient (``axis``) and variable-Γ (``diff_field``)
Laplacian. The
FD preconditioner (``precond: "fd"``), periodic axes, obstacles and domain
decomposition are ported in later slices and raise
``NotImplementedError`` — never a silent detour to another path.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import TypedDict

import numpy as np
import torch

from pyapes_tpu_torch.mesh.tools import boundary_slicer
from pyapes_tpu_torch.solver.fastdiag import _symmetrize_similarity, axis_matrix_np
from pyapes_tpu_torch.solver.linalg.build import (
    _MG_CACHE,
    build_solver,
    fastdiag_factors,
    fd_separable,
)
from pyapes_tpu_torch.utils.carry import coeffs_from_numpy


class ReportType(TypedDict):
    """Solver report (reference ``linalg.py:22-30``)."""

    itr: int
    tol: float
    converge: bool


_UNPORTED_CONFIG = ("decomp", "debug", "kernel")
# Eigen-factors by CONTENT: the coefficient vectors' bytes, the active
# set, dtype and device are all they depend on, so a time-stepping or
# repeated solve re-factorizes nothing. Bounded LRU.
_FD_CACHE: OrderedDict = OrderedDict()
_FD_CACHE_MAX = 16


def clear_cache() -> None:
    _FD_CACHE.clear()
    _MG_CACHE.clear()


def _cached_factors(tparams, slicer, x0):
    key = (
        str(x0.dtype),
        str(x0.device),
        tuple((s.start, s.stop) for s in slicer),
        tuple((c.dtype.str, c.tobytes()) for cs in tparams[0]["axis_np"] for c in cs),
    )
    if key not in _FD_CACHE:
        _FD_CACHE[key] = fastdiag_factors(tparams, slicer, x0.dtype, x0.device)
        while len(_FD_CACHE) > _FD_CACHE_MAX:
            _FD_CACHE.popitem(last=False)
    _FD_CACHE.move_to_end(key)
    return _FD_CACHE[key]


def _term_descriptor(rec) -> tuple:
    """Static (hashable) description of one equation term:
    ``(kind, name, sign, has_param, surgery, form)``. ``kind`` "axis" (the
    per-axis coefficient stencil; surgery and form None) or "diff_field"
    (the variable-Γ Laplacian; ``surgery`` the per-axis BC kinds, ``form``
    ``(inv_dx2, avg)``)."""
    name = rec["name"].lower()
    if name == "laplacian" and (rec.get("other") or {}).get("var_gamma"):
        o = rec["other"]
        return ("diff_field", name, float(rec["sign"]), False, o["surgery"],
                (o["inv_dx2"], o["avg"]))
    if name != "laplacian" or rec.get("axis_coeffs") is None:
        raise NotImplementedError(f"linalg: {rec['name']} terms are ported in a later slice")
    return ("axis", name, float(rec["sign"]), rec["param"][0] is not None, None, None)


def _term_params(rec, desc, x0: torch.Tensor) -> dict:
    """Per-call operands of one term: Γ on the solve's device and dtype
    (``diff_field``); else the coefficient vectors on the device
    (``axis``), their host copies for the factorization (``axis_np``) and
    the scalar coefficient."""
    if desc[0] == "diff_field":
        g = torch.as_tensor(rec["param"][0], dtype=x0.dtype, device=x0.device)
        return {"gamma": g.contiguous()}
    p = {
        "axis": coeffs_from_numpy(rec["axis_coeffs"], x0.device, x0.dtype),
        "axis_np": rec["axis_coeffs"],
    }
    if desc[3]:
        p["param"] = float(rec["param"][0])
    return p


def _fd_fallback_method(config, term_descs, tparams, bcs, mesh) -> str:
    """Resolve ``method: "fastdiag"`` + ``fd_fallback``: ``"fastdiag"`` when
    the equation is exactly separable (cheap O(n) host probe: every axis
    diagonally symmetrizable), else the configured fallback.

    The JAX package's probe (``linalg.py:694-698``) also rejects any BC
    that carries a ``bc_mask`` — which every domain BC does — so there the
    fallback is always taken; the port tests for obstacles, as intended."""
    fd_ok = not mesh.obstacle and fd_separable(term_descs, tparams)
    if fd_ok:
        sl = boundary_slicer(mesh.dim, bcs, mesh.coord_sys)
        try:
            for j in range(mesh.dim):
                _symmetrize_similarity(
                    axis_matrix_np(*tparams[0]["axis_np"][j], active=sl[j], periodic=False)
                )
        except ValueError:
            fd_ok = False
    return "fastdiag" if fd_ok else str(config["fd_fallback"]).lower()


def _check_config(config) -> None:
    for k in _UNPORTED_CONFIG:
        if config.get(k) not in (None, "auto"):
            raise NotImplementedError(f"linalg: config {k!r} is ported in a later slice")
    if config.get("sync", True) is False:
        raise NotImplementedError("linalg: sync=False is ported in a later slice")
    precond = config.get("precond")
    if precond not in (None, "mg"):
        raise NotImplementedError(f"linalg: precond {precond!r} is ported in a later slice")
    fd_opts = dict(config.get("fd_opts") or {})
    if fd_opts.pop("precision", "highest") != "highest" or fd_opts:
        raise NotImplementedError(
            "linalg: fd_opts other than precision='highest' are ported in a later slice"
        )


def solve(var, rhs, eqs: dict, config, mesh) -> ReportType:
    """Solve the captured linear system; the solution is written to ``var``.

    Args:
        var: target ``Field``.
        rhs: right-hand side tensor (BC adjustments already folded in).
        eqs: equation-term records from ``Solver.set_eq``.
        config: ``FDMSolverConfig``.
        mesh: the mesh.
    """
    method = config["method"].lower()
    if method not in ("cg", "bicgstab", "fastdiag"):
        raise RuntimeError(
            f"Linalg: solver supports CG, BICGSTAB and FASTDIAG. {method=} is not supported."
        )
    _check_config(config)
    assert min(mesh.nx) >= 3, "Linalg: minimum grid size is 3 per direction"

    tol = float(config.get("tol", 1e-6))
    max_it = int(config.get("max_it", 1000))

    x0 = var()
    terms = [eqs[k] for k in sorted(eqs)]
    term_descs = tuple(_term_descriptor(rec) for rec in terms)
    tparams = tuple(_term_params(rec, d, x0) for rec, d in zip(terms, term_descs))

    if method == "fastdiag" and config.get("fd_fallback"):
        method = _fd_fallback_method(config, term_descs, tparams, var.bcs, mesh)

    slicer = tuple(boundary_slicer(mesh.dim, var.bcs, mesh.coord_sys))
    fd = None
    if method == "fastdiag":
        if not fd_separable(term_descs, tparams):
            raise ValueError(
                "fastdiag: equation must be one 3-point axis term (laplacian) "
                "with a scalar coefficient"
            )
        fd = _cached_factors(tparams, slicer, x0)
    grid = mesh.grid
    fn, sym_vecs = build_solver(
        config, mesh, x0, grid, term_descs, tparams, var.bcs, method,
        config.get("criterion", "delta"), tol, max_it, slicer, fd,
    )
    if sym_vecs is not None:
        # the operator is row-scaled to symmetric; scale b identically
        for d in sym_vecs:
            rhs = rhs * d

    bc_vals = tuple(bc.stream_values(x0, grid, t=var.t) for bc in var.bcs)
    x_final, itr, tol_final, hist = fn(x0, rhs, tparams, bc_vals)
    if np.isnan(tol_final) or np.isinf(tol_final):
        raise RuntimeError(f"Invalid tolerance detected! tol: {tol_final}")
    var.VAR = x_final

    # Krylov: converged means the loop stopped before max_it (the JAX
    # rule); fastdiag's stall exit can stop before max_it at the dtype's
    # accuracy floor, so there converged means the tolerance was MET
    converge = tol_final <= tol if method == "fastdiag" else itr < max_it
    out: ReportType = {"itr": itr, "tol": tol_final, "converge": converge}
    if config.get("report", False):
        print(f"\n{method.upper()}: The solution converged after {itr} iteration.")
        print(f"\ttolerance: {tol_final}")
    if config.get("history"):
        out["history"] = np.asarray(hist)
    return out
