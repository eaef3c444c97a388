"""Ready-made problem templates built on the solver stack: Poisson,
advection-diffusion, the viscous Burgers systems, the lid-driven cavity,
the inflow/outflow channel (with immersed bodies), the periodic box and
the viscosity laws, Boussinesq natural convection and the Rosenbluth–Fokker–Planck evolution
with its self-consistent potentials."""
from pyapes_tpu_torch.models.advection_diffusion import AdvectionDiffusion
from pyapes_tpu_torch.models.burgers import Burgers1D, BurgersND
from pyapes_tpu_torch.models.natural_convection import NaturalConvection
from pyapes_tpu_torch.models.navier_stokes import (
    ChannelFlow,
    LidDrivenCavity,
    PeriodicFlow,
    carreau_viscosity,
    power_law_viscosity,
    smagorinsky_viscosity,
)
from pyapes_tpu_torch.models.poisson import PoissonSolver
from pyapes_tpu_torch.models.rfp_evolution import RFPEvolution
from pyapes_tpu_torch.models.rosenbluth import RosenbluthPotentials

__all__ = ["AdvectionDiffusion", "Burgers1D", "BurgersND", "ChannelFlow", "LidDrivenCavity",
           "NaturalConvection", "PeriodicFlow", "PoissonSolver", "RFPEvolution",
           "RosenbluthPotentials", "carreau_viscosity", "power_law_viscosity",
           "smagorinsky_viscosity"]
