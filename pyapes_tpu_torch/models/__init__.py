"""Ready-made problem templates built on the solver stack: Poisson,
advection-diffusion, and the viscous Burgers systems."""
from pyapes_tpu_torch.models.advection_diffusion import AdvectionDiffusion
from pyapes_tpu_torch.models.burgers import Burgers1D, BurgersND
from pyapes_tpu_torch.models.poisson import PoissonSolver

__all__ = ["AdvectionDiffusion", "Burgers1D", "BurgersND", "PoissonSolver"]
