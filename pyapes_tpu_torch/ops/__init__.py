"""Stencil tier: the plain PyTorch stencils (``stencil``), the hand-written
Hopper kernels that replace the Pallas TPU stencils (``axis_stencil``:
stencil apply and apply + alpha-dot; ``jacobi``: the V-cycle's fused
Jacobi/residual, Jacobi + dot and double-sweep kernels; ``diff_field``:
the variable-Γ diffusion apply and its fused Jacobi/residual pass), and
their build (``cuda_build``)."""
from pyapes_tpu_torch.ops.stencil import apply_axis_stencil

__all__ = ["apply_axis_stencil"]
