"""Spatial domain decomposition of the grid into blocks (PyTorch port of
``pyapes_tpu/parallel/decomp.py``).

The JAX package is single-controller: one process drives every device,
each device owns one contiguous block of the grid, and the stencil's
neighbour reads become halo exchanges (``parallel/halo.py``). The port
keeps that design in one process with one block per sub-domain, in two
forms:

* ``devices=None``: every block is a view of the one global tensor on the
  solve's device; the halo exchange is a device copy and each block's
  stencil is its own kernel launch on a halo-extended copy.
* ``devices=(d0, d1, ...)`` (one per block, row-major block order, entries
  may repeat): the decomposition is *placed*. Each block of every loop
  vector of a solve is its own allocation on its device
  (``parallel/blocks.py``, the counterpart of a ``NamedSharding``-committed
  array): only the ghost faces move between blocks, reductions are summed
  from per-block partials on the solve's device in block order, and each
  block's kernel launches on its block's device.

A per-axis transform along a cut axis (the fast-diagonalization solve)
runs in a *pencil* layout: the same devices in the same block order, cut
another way so that the transformed axis is whole (``pencil_plan``,
``DomainDecomposition.pencil``); ``blocks.repartition`` moves a block
vector between two such cuts (the all-to-all GSPMD inserts for the JAX
package's sharded contraction).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import torch


def _resolve(d) -> torch.device:
    """``d`` as a device this machine has, with its index; raises
    ``ValueError`` for one it lacks (nothing falls back to another
    device)."""
    d = torch.device(d)
    if d.type == "cpu":
        return torch.device("cpu")
    if d.type != "cuda":
        raise ValueError(f"DomainDecomposition: device {d} is not a CPU or CUDA device")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    idx = d.index if d.index is not None else (torch.cuda.current_device() if n else 0)
    if idx >= n:
        raise ValueError(f"DomainDecomposition: device cuda:{idx} does not exist (this machine "
                         f"shows {n} CUDA device{'s' if n != 1 else ''})")
    return torch.device("cuda", idx)


@dataclass(frozen=True)
class DomainDecomposition:
    """Maps grid axes onto blocks.

    Args:
        mesh_shape: blocks per grid axis, e.g. ``(4, 2, 1)`` cuts the first
            grid axis into 4 and the second into 2 blocks; ``1`` keeps an
            axis whole.
        axis_names: names of the block axes (default ``sx, sy, sz``).
        devices: None (every block a view on the solve's device), or one
            device per block in row-major block order (``blocks()``): the
            placed decomposition. More entries than blocks take the first
            ``n_devices`` (as the JAX package); fewer raise ``ValueError``,
            and so does a device the machine lacks.

    Example:
        >>> dd = DomainDecomposition((4, 2, 1))
        >>> [sl for _, sl in dd.blocks((16, 16, 128))][1]
        (slice(0, 4, None), slice(8, 16, None), slice(0, 128, None))
        >>> DomainDecomposition((2, 1), devices=("cpu", "cpu")).placed
        True
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
            devs = tuple(self.devices)
            if len(devs) < self.n_devices:  # JAX decomp.py:69-72
                raise ValueError(f"DomainDecomposition: needs {self.n_devices} devices, "
                                 f"have {len(devs)}")
            object.__setattr__(self, "devices",
                               tuple(_resolve(d) for d in devs[: self.n_devices]))

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.mesh_shape))

    @property
    def placed(self) -> bool:
        """Whether each block lives in its own allocation on its device."""
        return self.devices is not None

    def check_device(self, device) -> None:
        """The placement check of a solve on ``device`` (the lead device):
        it and every block's device must exist on this machine (raises
        ``ValueError`` otherwise). A placed block may sit on any device."""
        _resolve(device)
        for d in self.devices or ():
            _resolve(d)

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

    def pencil(self, mesh_shape) -> "DomainDecomposition":
        """The same devices, in the same block order, with the grid cut into
        ``mesh_shape`` blocks instead (a pencil layout of ``pencil_plan``);
        raises ``ValueError`` for another number of blocks."""
        mesh_shape = tuple(int(m) for m in mesh_shape)
        if int(np.prod(mesh_shape)) != self.n_devices:
            raise ValueError(f"DomainDecomposition: a pencil cut {mesh_shape} of {self.n_devices} "
                             "blocks")
        return DomainDecomposition(mesh_shape, devices=self.devices)

    def placement(self, global_shape) -> list:
        """``[(coord, slices, device), ...]`` in row-major block order:
        ``blocks()`` with each block's device (None where the
        decomposition is not placed)."""
        devs = self.devices or (None,) * self.n_devices
        return [(c, sl, d) for (c, sl), d in zip(self.blocks(global_shape), devs)]


def pencil_plan(mesh_shape, global_shape) -> tuple:
    """The pencil cuts a per-axis transform of a grid of ``global_shape``
    cut into ``mesh_shape`` blocks runs in: ``((axis, cut), ...)``, one per
    grid axis in the order of the transforms (the axes whole in
    ``mesh_shape`` first, then the cut ones, each in index order), ``cut``
    a cut of the same number of blocks in which ``axis`` is whole. Each
    step hands the blocks of the next axis to one other axis (a whole one
    where one takes them, else the last that does): at (4, 2, 1) axis 2
    is transformed in place, then (1, 2, 4) makes axis 0 whole and (2, 1,
    4) axis 1. Raises ``NotImplementedError`` where no other axis divides
    into the blocks it would take (the pencil cannot divide; a placed
    solve never gathers instead)."""
    shape = tuple(int(n) for n in global_shape)
    cur = list(mesh_shape) + [1] * (len(shape) - len(mesh_shape))
    plan = []
    for a in [j for j, m in enumerate(cur) if m == 1] + [j for j, m in enumerate(cur) if m > 1]:
        if cur[a] > 1:
            takers = [w for w in range(len(shape)) if w != a and shape[w] % (cur[w] * cur[a]) == 0]
            if not takers:
                raise NotImplementedError(
                    f"DomainDecomposition: no pencil makes axis {a} of the grid {shape} whole from "
                    f"the cut {tuple(cur)}: no other axis divides into {cur[a]} times its blocks. "
                    "Choose node counts divisible by the device count on every axis.")
            w = min(takers, key=lambda w: (cur[w] != 1, -w))
            cur[w] *= cur[a]
            cur[a] = 1
        plan.append((a, tuple(cur)))
    return tuple(plan)
