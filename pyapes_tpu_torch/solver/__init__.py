"""Solver layer: the explicit (FDC) / implicit (FDM) discretizations, the
fast-diagonalization solve and the differentiable (adjoint) solves."""
from pyapes_tpu_torch.solver.adjoint import (
    DifferentiableDiffusionSolve,
    DifferentiableSolve,
)
from pyapes_tpu_torch.solver.fdc import FDC
from pyapes_tpu_torch.solver.fdm import FDM
from pyapes_tpu_torch.solver.ops import Solver

__all__ = ["DifferentiableDiffusionSolve", "DifferentiableSolve", "FDC", "FDM", "Solver"]
