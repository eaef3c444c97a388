"""Spatial domain decomposition of the grid into blocks (PyTorch port of
``pyapes_tpu/parallel/decomp.py``).

The JAX package is single-controller: one process drives every device,
each device owns one contiguous block of the grid, and the stencil's
neighbour reads become halo exchanges (``parallel/halo.py``). The port
keeps that design in one process with one block per sub-domain. In this
version every block lives on the solve's device: the blocks are views of
the one global tensor, the halo exchange is a device copy, and each
block's stencil is its own kernel launch on a halo-extended copy. Blocks
on several cards are later work: a ``devices`` tuple that names another
device raises ``NotImplementedError``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class DomainDecomposition:
    """Maps grid axes onto blocks.

    Args:
        mesh_shape: blocks per grid axis, e.g. ``(4, 2, 1)`` cuts the first
            grid axis into 4 and the second into 2 blocks; ``1`` keeps an
            axis whole.
        axis_names: names of the block axes (default ``sx, sy, sz``).
        devices: None, or one device per block; every entry must be the
            solve's device (blocks on several devices are not ported yet).

    Example:
        >>> dd = DomainDecomposition((4, 2, 1))
        >>> [sl for _, sl in dd.blocks((16, 16, 128))][1]
        (slice(0, 4, None), slice(8, 16, None), slice(0, 128, None))
    """

    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...] = field(default=())
    devices: tuple | None = None

    def __post_init__(self):
        object.__setattr__(self, "mesh_shape", tuple(int(m) for m in self.mesh_shape))
        if not self.axis_names:
            object.__setattr__(self, "axis_names",
                               tuple(f"s{n}" for n in "xyz"[: len(self.mesh_shape)]))
        if len(self.axis_names) != len(self.mesh_shape) or min(self.mesh_shape, default=1) < 1:
            raise ValueError(f"DomainDecomposition: bad mesh_shape {self.mesh_shape} / "
                             f"axis_names {self.axis_names}")
        if self.devices is not None:
            object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.mesh_shape))

    def check_device(self, device) -> None:
        """Accept ``devices=None`` or devices that are all ``device`` (the
        solve's); raise ``NotImplementedError`` for any other device."""
        device = torch.device(device)
        for d in self.devices or ():
            same = d.type == device.type and (d.index is None or device.index is None
                                              or d.index == device.index)
            if not same:
                raise NotImplementedError(
                    f"DomainDecomposition: a block on {d} while the solve runs on {device}; "
                    "blocks on several devices are ported in a later slice"
                )

    def blocks(self, global_shape):
        """Yield ``(coord, slices)`` per block in row-major block order:
        the block's coordinate along each block axis and its index ranges
        along each grid axis (an axis beyond ``mesh_shape`` stays whole).
        The counterpart of ``spec``/``sharding``. Raises ``ValueError``
        where an axis does not divide into its blocks."""
        global_shape = tuple(int(n) for n in global_shape)
        if len(self.mesh_shape) > len(global_shape):
            raise ValueError(f"DomainDecomposition: {len(self.mesh_shape)} block axes for a "
                             f"{len(global_shape)}-D grid")
        ms = self.mesh_shape + (1,) * (len(global_shape) - len(self.mesh_shape))
        if any(n % m for n, m in zip(global_shape, ms)):
            raise ValueError(f"DomainDecomposition: grid {global_shape} does not divide into "
                             f"{ms} blocks")
        size = [n // m for n, m in zip(global_shape, ms)]
        for coord in itertools.product(*(range(m) for m in ms)):
            yield coord, tuple(slice(c * b, (c + 1) * b) for c, b in zip(coord, size))
