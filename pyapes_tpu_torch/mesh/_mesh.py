"""Equidistant rectangular mesh (PyTorch port of ``pyapes_tpu/mesh/_mesh.py``).

  * Coordinates and boundary masks are computed **on the host with numpy**
    once at construction (float64); masks stay host numpy.
  * ``x`` are 1-D tensors on ``mesh.device`` in the simulation dtype; the
    N-D coordinate grid is never cached: ``grid`` is a lazy sequence whose
    axes are broadcast VIEWS of the 1-D vectors (``Tensor.expand``, no
    memory) until a consumer computes with them.
"""
from __future__ import annotations

from functools import cached_property
from typing import Optional

import numpy as np
import torch

from pyapes_tpu_torch.backend import (
    DTYPE_DOUBLE,
    DTYPE_HALF,
    DTYPE_SINGLE,
    Device,
    DType,
)
from pyapes_tpu_torch.geometry import GeoTypeIdentifier
from pyapes_tpu_torch.geometry.basis import DIR_TO_NUM, DIR_TO_NUM_RZ, Geometry
from pyapes_tpu_torch.geometry.mask import MaskObstacle


class Mesh:
    """Equidistant rectangular mesh (reference ``_mesh.py:19-318``).

    Args:
        domain: Domain geometry (``Box`` or ``Cylinder``).
        obstacle: Optional list of inner obstacles: ``Box`` bodies or
            ``MaskObstacle`` shapes (``_mesh.py:110-135``).
        spacing: list of ints (node counts) or floats (cell sizes)
            (``_mesh.py:67-80``).
        device: "cuda" (the default) | "gpu" | "cpu"; CUDA raises where it
            is unavailable (there is no fallback to the CPU).
        dtype: "single" | "double" | "half".
    """

    def __init__(
        self,
        domain: Geometry,
        obstacle: Optional[list[Geometry]] = None,
        spacing: list[int] | list[float] | None = None,
        device: str = "cuda",
        dtype: str | int = "double",
    ):
        spacing = [] if spacing is None else spacing
        self.device: torch.device = Device(device).device
        assert (
            dtype in DTYPE_DOUBLE or dtype in DTYPE_SINGLE or dtype in DTYPE_HALF
        ), "Mesh: dtype must be single, double, or half"
        self.dtype = DType(dtype)

        self.domain = domain
        if self.coord_sys == "rz":
            assert self.dim == 2, "Mesh: rz coordinate system only accepts 2D domain"
        self.obstacle = obstacle

        lower = np.asarray(domain.lower, dtype=np.float64)
        upper = np.asarray(domain.upper, dtype=np.float64)
        self._lx_np = upper - lower

        if int in GeoTypeIdentifier(spacing):
            self._nx: list[int] = [int(s) for s in spacing]
            self._dx: list[float] = [
                float(l / (n - 1.0)) for l, n in zip(self._lx_np, self._nx)
            ]
        elif float in GeoTypeIdentifier(spacing):
            self._dx = [float(s) for s in spacing]
            self._nx = [int(l / d + 1.0) for l, d in zip(self._lx_np, self._dx)]
        else:
            raise TypeError("Mesh: spacing only accepts int or float")

        # Host (numpy, float64) coordinates — static metadata.
        self._x_np: list[np.ndarray] = [
            np.linspace(lower[i], upper[i], self._nx[i]) for i in range(self.dim)
        ]
        self.x: list[torch.Tensor] = [
            torch.as_tensor(x, dtype=self.dtype.float, device=self.device)
            for x in self._x_np
        ]

        self._lower_np = lower
        self._upper_np = upper

        # Boundary masks (host numpy bools).
        self.d_mask, self.o_mask = boundary_mask(self)

        t_mask = np.zeros(self.nx, dtype=bool)
        for dm in self.d_mask:
            t_mask |= self.d_mask[dm]
        for o_idx in self.o_mask:
            for om in self.o_mask[o_idx]:
                t_mask |= self.o_mask[o_idx][om]
        self.t_mask: np.ndarray = t_mask
        """Union of all domain and obstacle masks (``_mesh.py:102-116``)."""

    # -- identity ---------------------------------------------------------
    def __repr__(self) -> str:
        return f"{self.domain} with dx={self._dx}"

    def __hash__(self) -> int:
        return id(self)

    def __eq__(self, other) -> bool:
        return self is other

    @cached_property
    def obstacle_body_masks(self) -> list[np.ndarray]:
        """Filled (solid-body) mask per obstacle, snapped to the grid with
        the same rule as the face masks (``get_box_mask``). The face masks
        in ``o_mask`` cover only the surface shell; Neumann obstacle BCs
        exclude the whole body from the solver's active set."""
        out: list[np.ndarray] = []
        for obj in self.obstacle or []:
            if getattr(obj, "type", "") == "mask":
                out.append(obj.resolve(self._grid_np))
                continue
            mask = np.zeros(self.nx, dtype=bool)
            slicer = []
            for i in range(self.dim):
                x = self._x_np[i]
                i0 = int(np.argmin(np.abs(x - obj.lower[i])))
                i1 = int(np.argmin(np.abs(x - obj.upper[i])))
                slicer.append(slice(i0, i1 + 1))
            mask[tuple(slicer)] = True
            out.append(mask)
        return out

    @property
    def grid(self) -> "LazyGrid":
        """Full N-D coordinate grid, one broadcast view per axis.

        Each axis is ``x[i]`` expanded to ``nx`` without copying; a full
        cube of memory exists only when a consumer (a callable BC, a
        manufactured RHS) computes with it, and is freed when it drops the
        result."""
        return LazyGrid(self)

    def _grid_axis(self, i: int) -> torch.Tensor:
        shape = [1] * self.dim
        shape[i] = -1
        return self.x[i].reshape(shape).expand(self.nx)

    @cached_property
    def _grid_np(self) -> list[np.ndarray]:
        return list(np.meshgrid(*self._x_np, indexing="ij"))

    # -- coordinate system ------------------------------------------------
    @property
    def coord_sys(self) -> str:
        """``xyz`` (Cartesian) or ``rz`` (axisymmetric), from the domain type
        (``_mesh.py:122-131``)."""
        if self.domain.type == "box":
            return "xyz"
        elif self.domain.type == "cylinder":
            return "rz"
        raise TypeError(f"Mesh: domain type {self.domain.type} not identifiable")

    def d_mask_dim(self, d_face: str) -> int:
        return (DIR_TO_NUM_RZ if self.coord_sys == "rz" else DIR_TO_NUM)[d_face[0]]

    def d_mask_dir(self, d_face: str) -> int:
        """Face normal direction: -1 lower, +1 upper."""
        return 1 if d_face[1] == "u" else -1

    def d_mask_shift(self, d_face: str, shift: int) -> np.ndarray:
        """Shift the domain mask toward the inner side (``_mesh.py:143-170``)."""
        face_dim = self.d_mask_dim(d_face)
        face_dir = self.d_mask_dir(d_face)
        return np.roll(self.d_mask[d_face], -shift * face_dir, face_dim)

    # -- grid properties --------------------------------------------------
    @property
    def _depth(self) -> float:
        if self.dim == 1:
            return self._dx[0] * self._dx[0]
        elif self.dim == 2:
            return self._dx[0]
        return 1.0

    @property
    def dim(self) -> int:
        return self.domain.dim

    @property
    def R(self) -> torch.Tensor:
        if self.coord_sys != "rz":
            raise KeyError("Mesh: R coordinate only available in axisymmetric case.")
        return self.grid[0]

    @property
    def X(self) -> torch.Tensor:
        return self.grid[0]

    @property
    def Y(self) -> torch.Tensor:
        if self.coord_sys == "xyz" and self.dim > 1:
            return self.grid[1]
        return torch.empty(0, dtype=self.dtype.float, device=self.device)

    @property
    def Z(self) -> torch.Tensor:
        if self.coord_sys == "rz":
            return self.grid[1]
        if self.dim > 2:
            return self.grid[2]
        return torch.empty(0, dtype=self.dtype.float, device=self.device)

    @property
    def N(self) -> int:
        return int(np.prod(self._nx))

    @property
    def size(self) -> float:
        return self.domain.size

    def _vec(self, vals) -> torch.Tensor:
        return torch.as_tensor(
            np.asarray(vals, dtype=np.float64),
            dtype=self.dtype.float,
            device=self.device,
        )

    @property
    def lx(self) -> torch.Tensor:
        return self._vec(self._lx_np)

    @property
    def dx(self) -> torch.Tensor:
        return self._vec(self._dx)

    @property
    def dx_np(self) -> np.ndarray:
        """Host copy of the spacing (used in static coefficient surgery)."""
        return np.asarray(self._dx)

    @cached_property
    def dg(self) -> list[torch.Tensor]:
        """Boundary-corrected grid spacing (``_mesh.py:262-293``)."""
        del_grid: list[torch.Tensor] = []
        for idx, g in enumerate(self._grid_np):
            g_rp = np.roll(g, -1, idx) - g
            g_rm = g - np.roll(g, 1, idx)
            g_rp[g_rp < 0.0] = 0.0
            g_rm[g_rm < 0.0] = 0.0
            del_grid.append(self._vec((g_rp + g_rm) / 2))
        return del_grid

    @property
    def nx(self) -> tuple[int, ...]:
        return tuple(self._nx)

    @property
    def lower(self) -> torch.Tensor:
        return self._vec(self._lower_np)

    @property
    def upper(self) -> torch.Tensor:
        return self._vec(self._upper_np)

    @property
    def center(self) -> torch.Tensor:
        return self.lx * 0.5

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"


class LazyGrid:
    """Sequence of per-axis coordinate grids, built on first access.

    Supports ``grid[i]``, negative indices, slices, ``len`` and iteration.
    Each axis is a broadcast view of the mesh's 1-D coordinate vector."""

    def __init__(self, mesh: Mesh):
        self._mesh = mesh

    def __len__(self) -> int:
        return self._mesh.dim

    def __getitem__(self, i):
        if isinstance(i, slice):
            return tuple(self[j] for j in range(*i.indices(len(self))))
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return self._mesh._grid_axis(i)

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def boundary_mask(mesh: Mesh) -> tuple[dict, dict]:
    """Create face masks for the domain and the obstacles
    (``_mesh.py:321-372``): ``(domain_mask, object_mask)``, host numpy
    bool arrays keyed by face id (per obstacle index for the second).
    A ``Box`` obstacle's faces snap like the domain's; a ``MaskObstacle``
    gets its surface shells by neighbour differencing of the solid mask,
    the faces no cell of the body lies on left out."""
    x = mesh._x_np
    dx = np.asarray(mesh._dx)
    domain = mesh.domain
    domain_mask: dict[str, np.ndarray] = {}
    object_mask: dict[int, dict[str, np.ndarray]] = {}
    for obj in domain.config:
        mask = np.zeros(mesh.nx, dtype=bool)
        mask = get_box_mask(x, dx, domain.config[obj], mask, mesh.dim)
        domain_mask[str(domain.config[obj]["face"])] = mask
    for i, obj in enumerate(mesh.obstacle or []):
        if obj.type in ("box", "cylinder"):
            obj_mask = {}
            for o in obj.config:
                mask = np.zeros(mesh.nx, dtype=bool)
                mask = get_box_mask(x, dx, obj.config[o], mask, mesh.dim)
                obj_mask[str(obj.config[o]["face"])] = mask
            object_mask[i] = obj_mask
        elif obj.type == "mask":
            body = obj.resolve(mesh._grid_np)
            object_mask[i] = {k: m for k, m in MaskObstacle.shells(body).items() if m.any()}
        else:
            raise NotImplementedError(f"Mask: obstacle type {obj.type!r} is not supported")
    return domain_mask, object_mask


def get_box_mask(
    x: list[np.ndarray],
    dx: np.ndarray,
    obj: dict,
    mask: np.ndarray,
    dim: int,
) -> np.ndarray:
    """Mark the face slab described by ``obj`` (``_mesh.py:375-399``): both
    the face origin and its far end snap to their nearest grid node. (The
    original reference extends by ``ceil(e_x / dx) + 1`` nodes instead,
    which leaves a misaligned obstacle box with faces that do not close
    into one body; the obstacle-Neumann shells would then extrapolate from
    inside it.)"""
    x_p = np.asarray(obj["x_p"], dtype=np.float64)
    e_x = np.asarray(obj["e_x"], dtype=np.float64)

    slicer = []
    for i in range(dim):
        i0 = int(np.argmin(np.abs(x[i] - x_p[i])))
        i1 = int(np.argmin(np.abs(x[i] - (x_p[i] + e_x[i]))))
        slicer.append(slice(i0, i1 + 1))

    mask[tuple(slicer)] = True
    return mask
