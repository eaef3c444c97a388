"""Spatial domain decomposition: blocks of the grid, their halo exchange
and the block-wise stencil and advection applies (``halo``), and the
block-resident vectors of a placed decomposition (``blocks``)."""
from pyapes_tpu_torch.parallel.decomp import DomainDecomposition

__all__ = ["DomainDecomposition"]
