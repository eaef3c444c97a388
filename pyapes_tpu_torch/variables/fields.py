"""Field variable container (PyTorch port of ``pyapes_tpu/variables/fields.py``).

Arithmetic is **non-mutating**, matching the JAX package: ``a + b``
returns a new ``Field`` and never writes ``a``'s tensor. (The original
torch reference's ``__add__`` mutated ``self``, ``fields.py:256-316`` — an
aliasing hazard, SURVEY §2 quirk 1.) Component writes (``set_var_tensor``,
``__setitem__``) replace the payload with an updated copy, so a tensor
another holder still references (``VARo`` after ``save_old``) never
changes underneath it.

A Field's value may be a block vector of a placed decomposition
(``parallel.blocks.BlockTensor``, e.g. ``var.VAR = blocks.put(var(),
decomp)``, the counterpart of committing the JAX package's value with
``jax.device_put``): the setters, component reads and writes, the
arithmetic, the history levels and ``apply_bcs`` keep it on its blocks,
and a solve returns the solution on them. ``init_val`` may be one too:
then no whole array is made.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from pyapes_tpu_torch.mesh import Mesh
from pyapes_tpu_torch.parallel import blocks
from pyapes_tpu_torch.parallel.blocks import BlockTensor
from pyapes_tpu_torch.geometry.basis import DIR_TO_NUM, DIR_TO_NUM_RZ
from pyapes_tpu_torch.variables.bcs import (
    BC_FACTORY,
    BC_type,
    BCConfig,
    ObstacleDirichlet,
    ObstacleNeumann,
)


@dataclass
class Field:
    """Field variable (reference ``fields.py:19-422``).

    Examples:
        >>> mesh = Mesh(Box[0:1, 0:1], None, [21, 21])
        >>> f_bc = homogeneous_bcs(2, 0.0, "dirichlet")
        >>> var = Field("U", 1, mesh, {"domain": f_bc, "obstacle": None},
        ...             init_val=0.5)
    """

    name: str
    dim: int
    """Variable dimension (scalar field: 1). Not the mesh dimension!"""
    mesh: Mesh
    bc_config: dict[str, list[BCConfig] | None] | None = None
    init_val: Any = None
    object_interp: bool = False

    def __post_init__(self):
        iv = self.init_val
        self._VAR = self._as_tensor(iv) if isinstance(iv, BlockTensor) else self._zeros()
        self._VARo = self._VAR
        self._t = 0.0
        self._dt: float | None = None

        if iv is not None and not isinstance(iv, BlockTensor):
            if isinstance(iv, float):
                self._VAR = self._VAR + iv
            elif isinstance(iv, list):
                assert self.dim == len(iv), "Field: init_val should match with Field dimension!"
                val = self._VAR.clone()
                for d in range(self.dim):
                    val[d] += self._as_tensor(iv[d]) if not isinstance(iv[d], float) else iv[d]
                self._VAR = val
            elif isinstance(iv, (torch.Tensor, np.ndarray)) or hasattr(iv, "shape"):
                arr = self._as_tensor(iv)
                assert self.dim == arr.shape[0], "Field: init_val should match with Field dimension!"
                self._VAR = self._VAR + arr
            elif isinstance(iv, str) and iv.lower() == "random":
                self._VAR = torch.rand(
                    self._VAR.shape, dtype=self._VAR.dtype, device=self._VAR.device
                )
            else:
                raise ValueError("Field: unsupported data type!")

        if self.bc_config is not None:
            if "domain" not in self.bc_config:
                raise ValueError("Field: domain must be defined!")
            if "obstacle" not in self.bc_config:
                self.bc_config["obstacle"] = None

        self.set_bcs()

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(
            (self.dim, *self.mesh.nx), dtype=self.mesh.dtype.float, device=self.mesh.device
        )

    def _as_tensor(self, val) -> torch.Tensor:
        """``val`` in the mesh's dtype on its device; a block vector stays on
        its blocks (cast block by block)."""
        if isinstance(val, BlockTensor):
            return val if val.dtype == self.mesh.dtype.float else val.to(self.mesh.dtype.float)
        return torch.as_tensor(val, dtype=self.mesh.dtype.float, device=self.mesh.device)

    # -- time state (reference ``fields.py:109-145``) ---------------------
    @property
    def mesh_axis(self) -> list[int]:
        return [i + 1 for i in range(self.mesh.dim)]

    def set_time(self, dt: float, init_val: float | None = None) -> None:
        self._t = init_val if init_val is not None else 0.0
        self._dt = dt

    def update_time(self, dt: float | None = None) -> None:
        # rebinds, never adds in place: under a fused step ``_t`` is the
        # streamed clock tensor the fields share
        self._t = self._t + (self.dt if dt is None else dt)

    @property
    def t(self) -> float:
        return self._t

    def save_old(self) -> None:
        # History shift VARoo <- VARo <- VAR (two levels, for BDF2).
        self._VARoo = self._VARo
        self._VARo = self._VAR
        self._n_hist = getattr(self, "_n_hist", 0) + 1

    @property
    def VARo(self) -> torch.Tensor:
        return self._VARo

    @VARo.setter
    def VARo(self, other) -> None:
        self._VARo = self._as_tensor(other)

    @property
    def VARoo(self) -> torch.Tensor:
        """Second-oldest state (BDF2); falls back to VARo before two
        ``save_old`` calls have happened."""
        return getattr(self, "_VARoo", self._VARo)

    @property
    def n_hist(self) -> int:
        return getattr(self, "_n_hist", 0)

    @property
    def dt(self) -> float:
        assert self._dt is not None, "Field: No time step is specified."
        return self._dt

    # -- geometry passthrough ---------------------------------------------
    @property
    def dx(self) -> torch.Tensor:
        return self.mesh.dx

    @property
    def nx(self) -> tuple[int, ...]:
        return self.mesh.nx

    # -- payload access ----------------------------------------------------
    @property
    def VAR(self) -> torch.Tensor:
        return self._VAR

    @VAR.setter
    def VAR(self, other) -> None:
        self._VAR = self._as_tensor(other)

    def copy(self, name: str | None = None) -> "Field":
        copied = copy.copy(self)
        copied.bcs = list(self.bcs)
        if name is not None:
            copied.name = name
        return copied

    def zeros_like(self, name: str | None = None) -> "Field":
        copied = self.copy(name)
        copied._VAR = torch.zeros_like(self._VAR)
        return copied

    def zeros_like_tensor(self) -> torch.Tensor:
        return torch.zeros_like(self._VAR)

    @property
    def size(self) -> tuple[int, ...]:
        return tuple(self._VAR.shape)

    def sum(self, dim: int = 0) -> torch.Tensor:
        return torch.sum(self._VAR, dim=dim)

    def set_var_tensor(self, val, insert: int | None = None) -> "Field":
        """Assign values (reference ``fields.py:209-235``). Returns self."""
        val = self._as_tensor(val)
        if self.size == tuple(val.shape):
            self._VAR = val
        else:
            new = self._VAR.clone()
            for i in range(self.dim):
                if insert is None or i == insert:
                    new[i] = val
            self._VAR = new
        return self

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self._VAR
        return self._VAR[idx]

    def __setitem__(self, idx, val) -> None:
        if isinstance(idx, slice):
            self._VAR = self._as_tensor(val)
        else:
            new = self._VAR.clone()
            new[idx] = self._as_tensor(val)
            self._VAR = new

    def __call__(self) -> torch.Tensor:
        return self._VAR

    # -- arithmetic (non-mutating; reference mutates: ``fields.py:256-337``) --
    def _with(self, val: torch.Tensor) -> "Field":
        new = self.copy()
        new._VAR = val
        return new

    def __add__(self, other) -> "Field":
        if isinstance(other, Field):
            return self._with(self._VAR + other())
        if isinstance(other, float):
            return self._with(self._VAR + other)
        if isinstance(other, list):
            assert len(other) == self.dim, "Field: input vector should match with Field dimension!"
            val = self._VAR.clone()
            for i in range(self.dim):
                val[i] += other[i]
            return self._with(val)
        if hasattr(other, "shape"):
            other = self._as_tensor(other)
            if other.shape[0] == self.dim and other.shape == self._VAR.shape:
                return self._with(other)
            val = self._VAR.clone()
            for i in range(other.shape[0]):
                val[i] += other[i]
            return self._with(val)
        raise TypeError("Field: you can only add Field, float, Tensor, or list!")

    def __sub__(self, other) -> "Field":
        if isinstance(other, Field):
            return self._with(self._VAR - other())
        raise TypeError("Field: you can only subtract Field!")

    def __mul__(self, other) -> "Field":
        if isinstance(other, Field):
            return self._with(self._VAR * other())
        if isinstance(other, (float, int)):
            return self._with(self._VAR * other)
        raise TypeError("Field: you can only multiply Field, int, or float!")

    def __truediv__(self, other) -> "Field":
        if isinstance(other, Field):
            mask = other() > 0.0
            safe = torch.where(mask, other(), torch.ones_like(other()))
            return self._with(torch.where(mask, self._VAR / safe, self._VAR))
        raise TypeError("Field: you can only divide by Field!")

    def __ilshift__(self, other) -> "Field":
        """``var <<= other`` assignment (reference ``fields.py:318-337``)."""
        if isinstance(other, Field):
            return self._with(other())
        if isinstance(other, (float, int)):
            return self._with(torch.zeros_like(self._VAR) + other)
        if isinstance(other, list):
            assert self.dim == len(other), "Field: dimension mismatch!"
            val = torch.zeros_like(self._VAR)
            for i in range(self.dim):
                val[i] += other[i]
            return self._with(val)
        if hasattr(other, "shape"):
            new = self.copy()
            new.set_var_tensor(other)
            return new
        raise TypeError("Field: you can only assign Field, Tensor, float, int, or list!")

    def volume_integral(self, target=None) -> torch.Tensor:
        """Volume integral; 2*pi*r weight in rz (reference
        ``fields.py:339-359``)."""
        if target is None:
            target = torch.ones_like(self._VAR[0])
        dv = torch.prod(self.mesh.dx)
        if self.mesh.coord_sys == "rz":
            r = self.mesh.grid[0]
            return torch.stack(
                [torch.sum(2.0 * math.pi * self._VAR[i] * r * dv) for i in range(self.dim)]
            )
        return torch.stack([torch.sum(target * self._VAR[i] * dv) for i in range(self.dim)])

    # -- boundary conditions ------------------------------------------------
    def get_bc(self, bc_id: str) -> BC_type | None:
        """Lookup BC by id, e.g. ``"d-xl"`` (reference ``fields.py:361-376``)."""
        found = [bc for bc in self.bcs if bc.bc_id == bc_id]
        if len(found) == 0:
            return None
        if len(found) > 1:
            raise KeyError(f"Field: bc_id {bc_id} returned multiple bcs. Check id once again!")
        return found[0]

    def set_bcs(self) -> None:
        """Construct BC objects from config (reference ``fields.py:378-422``)."""
        self.bcs: list[BC_type] = []

        if self.bc_config is None or self.bc_config["domain"] is None:
            return
        d_obj_config = self.mesh.domain.config
        d_bc_config = self.bc_config["domain"]

        assert len(d_obj_config) == len(d_bc_config), (
            f"Field: domain config ({len(d_obj_config)}) mismatch "
            f"with bc config ({len(d_bc_config)})!"
        )

        for bc in d_bc_config:
            bc_face = bc["bc_face"]
            face_dim = (
                {"r": 0, "z": 1}[bc_face[0]]
                if self.mesh.coord_sys == "rz"
                else {"x": 0, "y": 1, "z": 2}[bc_face[0]]
            )
            self.bcs.append(
                BC_FACTORY[str(bc["bc_type"])](
                    bc_id=f"d-{bc_face}",
                    bc_val=bc["bc_val"],
                    bc_val_opt=bc.get("bc_val_opt"),
                    bc_face=bc_face,
                    bc_mask=self.mesh.d_mask[bc_face],
                    bc_var_name=self.name,
                    bc_coord_sys=self.mesh.coord_sys,
                    mesh_dim=self.mesh.dim,
                    dtype=self.mesh.dtype,
                    device=self.mesh.device,
                    dx_face=float(self.mesh.dx_np[face_dim]),
                )
            )
        if self.mesh.obstacle is not None and self.bc_config["obstacle"] is not None:
            self._set_obstacle_bcs(self.bc_config["obstacle"])

    def _set_obstacle_bcs(self, o_configs) -> None:
        """Obstacle BCs (JAX ``fields.py:340-410``), one config dict per
        obstacle (a single dict serves them all): "dirichlet" pins the
        shell, "neumann" extrapolates it from the fluid side."""
        mesh = self.mesh
        d2n = DIR_TO_NUM if mesh.coord_sys == "xyz" else DIR_TO_NUM_RZ
        if isinstance(o_configs, dict):
            o_configs = [o_configs] * len(mesh.o_mask)
        for i, oc in enumerate(o_configs):
            if oc is None:
                continue
            assert oc["bc_type"] in ("dirichlet", "neumann"), (
                "obstacle BCs: dirichlet or neumann (zero-flux)"
            )
            if oc["bc_type"] == "dirichlet":
                masks = list(mesh.o_mask[i].values())
                union = masks[0].copy()
                for m in masks[1:]:
                    union |= m
                self.bcs.append(ObstacleDirichlet(
                    bc_id=f"o{i}", bc_val=oc["bc_val"], bc_mask=union,
                    bc_val_opt=oc.get("bc_val_opt"),
                ))
            else:
                faces = []
                for fkey, m in mesh.o_mask[i].items():
                    axis = d2n[fkey[0]]
                    faces.append((m, axis, 1 if fkey[1] == "l" else -1, float(mesh.dx_np[axis])))
                self.bcs.append(ObstacleNeumann(
                    bc_id=f"o{i}", bc_val=oc["bc_val"], faces=faces,
                    body_mask=mesh.obstacle_body_masks[i],
                    all_body_masks=mesh.obstacle_body_masks,
                ))

    def apply_bcs(self) -> "Field":
        """Apply all BCs to the current values (returns self with a new
        payload); values resolve against the field's current time."""
        var = self._VAR.clone()
        grid = self.mesh.grid
        vals = [bc.stream_values(var, grid, t=self.t) for bc in self.bcs]
        if isinstance(var, BlockTensor):  # each face's rows in the blocks on it
            blocks.apply_bcs_fn(self.bcs, grid, var.placement, None)(var, vals, inplace=True)
        else:
            for bc, v in zip(self.bcs, vals):
                bc.apply_(var, grid, vals=v)
        self._VAR = var
        return self
