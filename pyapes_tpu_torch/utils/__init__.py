"""Utilities: checkpointing, VTK export, debugging, profiling."""
from pyapes_tpu_torch.utils import checkpoint, debug, io, profile

__all__ = ["checkpoint", "debug", "io", "profile"]
