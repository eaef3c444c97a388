"""OpenFOAM-inspired FDM solver front end (reference ``pyapes/solver/ops.py``).

Usage (the JAX package's surface):

    >>> fdm = FDM()
    >>> solver = Solver({"fdm": {"method": "fastdiag", "tol": 1e-6,
    ...                          "max_it": 1000, "report": True}})
    >>> solver.set_eq(fdm.laplacian(1.0, var) == rhs)
    >>> solver.solve()
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from pyapes_tpu_torch.parallel import blocks
from pyapes_tpu_torch.solver import linalg
from pyapes_tpu_torch.solver.fdm import Operators, ddt_leading_coeff
from pyapes_tpu_torch.solver.linalg import ReportType
from pyapes_tpu_torch.solver.tools import SolverConfig
from pyapes_tpu_torch.variables import Field


_SOLVE_LOG: list | None = None


@contextlib.contextmanager
def solve_log():
    """Within: every ``Solver.solve`` appends its report to the yielded list
    (the fused runner keeps a step's reports this way, and a caller can
    read the ``itr`` of each solve of an eager step)."""
    global _SOLVE_LOG
    prev, _SOLVE_LOG = _SOLVE_LOG, []
    try:
        yield _SOLVE_LOG
    finally:
        _SOLVE_LOG = prev


def _ddt_history(rec) -> torch.Tensor:
    """The history part of a Ddt term, times ``dt``: ``var_old``, or ``2
    var_old - 0.5 var_oold`` for an active BDF2."""
    tgt = rec["target"]
    if ddt_leading_coeff(rec) > 1.0:
        return 2.0 * tgt.VARo - 0.5 * tgt.VARoo
    return tgt.VARo


@dataclass(repr=False)
class Solver:
    """Finite-difference solver (reference ``ops.py:25-119``).

    ``config["fdm"]["picard"]``: outer Picard sweeps for a nonlinear Div
    term (advecting field == solution field): after each solve the frozen
    advection is refreshed from the new iterate and the system solved
    again."""

    config: None | SolverConfig = None

    def set_eq(self, eq: Operators) -> None:
        """Capture the assembled equation: target var, term records, RHS;
        fold the history of Ddt terms (backward Euler ``var_old / dt``,
        active BDF2 ``(2 var_old - 0.5 var_oold) / dt``) and the per-term
        RHS adjustments in, each multiplied by its term's sign (reference
        ``ops.py:47-81``)."""
        self.var = eq.var
        self.eqs = dict(eq.ops)
        self.rhs = eq.rhs

        if self.rhs is not None:
            for rec in self.eqs.values():
                if rec["name"] == "Ddt":
                    self.rhs = self.rhs + rec["sign"] * _ddt_history(rec) / rec["dt"]
                elif rec["adjust_rhs"] is not None:
                    self.rhs = self.rhs + rec["sign"] * rec["adjust_rhs"]()

        # Reset the shared operator state (reference ``ops.py:79-81``).
        eq.ops = {}
        eq.rhs = None

    def Aop(self, var: Field) -> torch.Tensor:
        """Debug interface: apply the assembled (affine) operator to ``var``
        (reference ``ops.py:83-90``); a Ddt term includes its ``-var_old /
        dt`` history, ``(x - var_old) / dt`` (BDF2: ``(1.5 x - 2 var_old +
        0.5 var_oold) / dt``). A value on blocks is applied on the lead
        device (one counted gather; a block Γ, advector or history one
        each) and comes back on its blocks."""
        assert self.eqs is not None, "Solver: equation is missing. Did you forget to set_eq?"

        def apply(x):
            res = torch.zeros_like(x)
            for rec in self.eqs.values():
                if rec["name"] == "Ddt":
                    lin = ddt_leading_coeff(rec) * x - blocks.lead_copy(_ddt_history(rec))
                    res = res + rec["sign"] * lin / rec["dt"]
                else:
                    res = res + rec["sign"] * rec["Aop"](rec, x)
            return res

        return blocks.via_lead(apply, var())

    def solve(self) -> ReportType:
        """Solve the captured linear system (reference ``ops.py:92-111``)."""
        assert self.var is not None and self.rhs is not None, (
            "Solver: target variable or rhs is missing. Didn't you forget to set equation?"
        )
        assert self.config is not None, "Solver: config is missing!"
        cfg = self.config["fdm"]
        n_picard = int(cfg.get("picard", 1))
        nonlinear = [rec for rec in self.eqs.values()
                     if rec.get("adv") is not None and rec["param"][0] is self.var]
        for sweep in range(max(1, n_picard)):
            self.report = linalg.solve(self.var, self.rhs, self.eqs, cfg, self.var.mesh)
            if _SOLVE_LOG is not None:
                _SOLVE_LOG.append(self.report)
            if not nonlinear or sweep == n_picard - 1:
                break
            for rec in nonlinear:  # refresh the frozen advection from the iterate
                rec["adv"] = self.var()
        return self.report

    def __repr__(self) -> str:
        desc = ""
        for op in self.eqs:
            desc += (
                f"{op} - {self.eqs[op]['name']}, "
                f"target: {self.eqs[op]['target']}, "
                f"param: {self.eqs[op]['param']}\n"
            )
        desc += f"{len(self.eqs) + 1} - RHS, input: {self.rhs}\n"
        return desc
