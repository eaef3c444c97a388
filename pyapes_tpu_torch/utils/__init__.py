"""Utilities: checkpointing, VTK export."""
