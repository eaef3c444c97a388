"""Boundary conditions for the FDM method (PyTorch port of
``pyapes_tpu/variables/bcs.py``, domain faces).

Supported: Dirichlet / Neumann / Symmetry / Periodic on the domain faces
``["xl","xu","yl","yu","zl","zu"]`` (``["rl","ru","zl","zu"]`` in rz),
with scalar, per-component list or callable values; and on immersed
obstacles (``ObstacleDirichlet``, static or dynamic, and
``ObstacleNeumann``, zero or nonzero flux), applied through masks that
are uploaded to the field's device once per BC. On a block vector of a
placed decomposition (``parallel.blocks.BlockTensor``) an obstacle applies
block by block: each block's cut of a static mask is kept on its device,
and a Neumann shell reads the sources it lacks from the neighbouring blocks
that hold them (``ObstacleNeumann._block_plans``: only those cells move).

``apply`` is pure, as in the JAX package: it returns a new tensor and
leaves its argument untouched. ``apply_`` is the in-place form; the
solver clones its iterate once and applies every BC in place on the
clone, where the JAX package produced one full-grid copy per face.

Sign convention (matches the reference behaviour): the Neumann value is
the gradient along the **outward face normal**; the applied update is
``p_face = 4/3 p1 - 1/3 p2 + 2/3 * V * dx`` on both sides
(``bcs.py:236-253``).
"""
from __future__ import annotations

import inspect
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, TypedDict

import numpy as np
import torch

from pyapes_tpu_torch.geometry.basis import DIR_TO_NUM, DIR_TO_NUM_RZ, FDIR, FDIR_RZ
from pyapes_tpu_torch.utils.device_cache import device_array, device_scalar

BC_val_type = Any
"""int | float | list | Callable | Tensor | None."""


class BCConfig(TypedDict, total=False):
    bc_face: str
    bc_type: str
    bc_val: BC_val_type
    bc_val_opt: dict | None


def _face_index(axis: int, i: int, leading: int = 1) -> tuple:
    """Index tuple selecting face row ``i`` along mesh-axis ``axis`` of an
    array with ``leading`` extra leading dims (e.g. the var-dim axis)."""
    return (slice(None),) * (leading + axis) + (i,)


@dataclass
class BC(ABC):
    """Abstract base boundary condition (reference ``bcs.py:45-194``)."""

    bc_id: str
    bc_val: BC_val_type
    bc_val_opt: dict | None
    bc_face: str
    bc_mask: np.ndarray
    bc_var_name: str
    bc_coord_sys: str
    mesh_dim: int
    dtype: Any
    device: Any
    dx_face: float = 0.0
    """Grid spacing along the face-normal axis (positive)."""

    def __post_init__(self):
        if self.bc_coord_sys == "rz":
            self._bc_face_dim = DIR_TO_NUM_RZ[self.bc_face[0]]
        else:
            self._bc_face_dim = DIR_TO_NUM[self.bc_face[0]]

        self._bc_n_dir: int = -1 if self.bc_face[-1] == "l" else 1
        self._bc_type = self.__class__.__name__.lower()

        m = np.asarray(self.bc_mask, dtype=bool)
        self.bc_mask = m

        self._bc_n_vec = np.zeros(3)
        self._bc_n_vec[self._bc_face_dim] = self._bc_n_dir

        # Domain BC masks are always the full boundary slab of their face
        # (``mesh/_mesh.py`` snaps faces to the grid): every node of the face
        # row and nothing else (counted, so no second grid-sized mask is made)
        face = m[_face_index(self._bc_face_dim, 0 if self._bc_n_dir < 0 else -1, 0)]
        self._is_slab = bool(face.all()) and int(np.count_nonzero(m)) == face.size

    # -- mask views (parity with ``bcs.py:97-155``) -----------------------
    def bc_mask_shift(self, shift: int) -> np.ndarray:
        return np.roll(self.bc_mask, shift, self._bc_face_dim)

    @property
    def bc_n_vec(self) -> np.ndarray:
        return self._bc_n_vec

    @property
    def bc_mask_prev(self) -> np.ndarray:
        return self.bc_mask_shift(-self._bc_n_dir)

    @property
    def bc_mask_prev2(self) -> np.ndarray:
        return self.bc_mask_shift(-self._bc_n_dir * 2)

    @property
    def bc_mask_forward(self) -> np.ndarray:
        return self.bc_mask_shift(self._bc_n_dir)

    @property
    def bc_mask_forward2(self) -> np.ndarray:
        return self.bc_mask_shift(self._bc_n_dir * 2)

    @property
    def bc_treat(self) -> bool:
        """True when stencil-coefficient surgery is required
        (``bcs.py:157-163``)."""
        return self._bc_type in ("neumann", "symmetry")

    @property
    def bc_type(self) -> str:
        return self._bc_type

    @property
    def bc_face_dim(self) -> int:
        return self._bc_face_dim

    @property
    def bc_n_dir(self) -> int:
        return self._bc_n_dir

    @property
    def type(self) -> str:
        return self._bc_type

    # -- value resolution --------------------------------------------------
    def _call_val(self, v, grid, var, t):
        """Invoke a callable BC value. Signature ``f(grid, mask, var, opt)``
        (reference ``bcs.py:204``); callables that also take a ``t``
        parameter (5th positional or keyword) receive the target field's
        current time."""
        try:
            params = inspect.signature(v).parameters
            wants_t = "t" in params or len(params) >= 5
        except (TypeError, ValueError):
            wants_t = False
        if wants_t:
            return v(grid, self.bc_mask, var, self.bc_val_opt, t)
        return v(grid, self.bc_mask, var, self.bc_val_opt)

    def _value_row(self, var: torch.Tensor, grid, var_dim: int, row_idx: int, t=None):
        """Resolve ``bc_val`` to something broadcastable to the face row."""
        v = self.bc_val
        if callable(v):
            full = torch.as_tensor(self._call_val(v, grid, var, t))
            if full.ndim == self.mesh_dim:
                return full[_face_index(self._bc_face_dim, row_idx, 0)]
            return full
        if isinstance(v, list):
            return float(v[var_dim])
        if isinstance(v, (int, float)):
            return float(v)
        if v is None:
            raise ValueError(f"BC {self.bc_id}: bc_val is not specified!")
        arr = torch.as_tensor(v)
        if arr.ndim == self.mesh_dim:
            return arr[_face_index(self._bc_face_dim, row_idx, 0)]
        return arr

    @property
    def streamable(self) -> bool:
        """Whether the value is resolved once per solve (``stream_values``)
        rather than at every application. Opt out — for callables that
        must see the evolving iterate — with
        ``bc_val_opt={"per_iteration": True}``."""
        if self._bc_type == "symmetry":
            return False  # no value
        if self.bc_val is None:
            return False
        if callable(self.bc_val) and ((self.bc_val_opt or {}).get("per_iteration")):
            return False
        return True

    def stream_values(self, var: torch.Tensor, grid, t=None):
        """Resolve the BC value per component once per solve call (``None``
        when not streamable); callables see the entry iterate and the
        field's current time."""
        if not self.streamable:
            return None
        i0 = 0 if self._bc_n_dir < 0 else -1
        out = []
        for d in range(var.shape[0]):
            v = self._value_row(var, grid, d, i0, t)
            if isinstance(v, (int, float)):  # a fill on the device, kept
                out.append(device_scalar(v, var.dtype, var.device))
            else:
                out.append(torch.as_tensor(v, dtype=var.dtype, device=var.device))
        return tuple(out)

    # -- application -------------------------------------------------------
    def apply(self, var: torch.Tensor, grid, var_dim: int | None = None, vals=None) -> torch.Tensor:
        """Apply the BC, returning a new tensor (``var`` is not modified).

        Args:
            var: field values, shape ``(var_dim, *nx)``.
            grid: mesh grid sequence.
            var_dim: apply to this component only; ``None`` applies to all.
            vals: optional pre-resolved per-component values
                (``stream_values`` output).
        """
        return self.apply_(var.clone(), grid, var_dim, vals)

    def apply_(self, var: torch.Tensor, grid, var_dim: int | None = None, vals=None) -> torch.Tensor:
        """In-place form of ``apply``: writes the face rows of ``var``."""
        if not self._is_slab:
            raise NotImplementedError("BC: non-face (obstacle) masks are not supported")
        dims = range(var.shape[0]) if var_dim is None else [var_dim]
        for d in dims:
            self._apply_one(var, grid, d, None if vals is None else vals[d])
        return var

    @abstractmethod
    def _apply_one(self, var: torch.Tensor, grid, d: int, val=None) -> None:
        ...


def _row(var: torch.Tensor, d: int, axis: int, i: int) -> torch.Tensor:
    return var[(d,) + _face_index(axis, i, 0)]


def _blocks_mod():
    from pyapes_tpu_torch.parallel import blocks  # parallel.blocks imports nothing of variables

    return blocks


def _block_mask(mask, lay, cache: dict | None):
    """The bool mask ``mask`` (host, the grid's shape) as a block vector
    ``(1, *grid)`` of ``lay``: each block's cut uploaded to its device, kept
    in ``cache`` per layout (a static body) or looked up by content in the
    device cache (``cache`` None: a dynamic body's mask of this call; no
    whole mask lands on a card)."""
    blocks = _blocks_mod()
    key = ("blocks", id(lay))
    if cache is not None and key in cache:
        return cache[key][1]
    parts = [device_array(np.ascontiguousarray(mask[sl])[None], device=dev)
             for _, sl, dev in lay.blocks]
    out = blocks.BlockTensor(parts, lay, (1, *lay.grid))
    if cache is not None:
        cache[key] = (lay, out)
    return out


class Dirichlet(BC):
    """Dirichlet BC (reference ``bcs.py:197-213``)."""

    def _apply_one(self, var, grid, d, val=None):
        a = self._bc_face_dim
        i0 = 0 if self._bc_n_dir < 0 else -1
        if val is None:
            val = self._value_row(var, grid, d, i0)
        var[(d,) + _face_index(a, i0, 0)] = val


class Neumann(BC):
    """Neumann BC, 2nd-order one-sided (reference ``bcs.py:216-253``):
    ``p_face = 4/3 p1 - 1/3 p2 + 2/3 V dx`` (outward-normal convention)."""

    def _apply_one(self, var, grid, d, val=None):
        a = self._bc_face_dim
        if self._bc_n_dir < 0:
            i0, i1, i2 = 0, 1, 2
        else:
            i0, i1, i2 = -1, -2, -3
        if val is None:
            val = self._value_row(var, grid, d, i0)
        p = _row(var, d, a, i1)
        pp = _row(var, d, a, i2)
        new = 4.0 / 3.0 * p - 1.0 / 3.0 * pp + 2.0 / 3.0 * val * self.dx_face
        var[(d,) + _face_index(a, i0, 0)] = new


class Symmetry(BC):
    """Symmetry BC: copy the adjacent interior row (reference ``bcs.py:256-262``)."""

    def _apply_one(self, var, grid, d, val=None):
        a = self._bc_face_dim
        i0, i1 = (0, 1) if self._bc_n_dir < 0 else (-1, -2)
        var[(d,) + _face_index(a, i0, 0)] = _row(var, d, a, i1)


class Periodic(BC):
    """Periodic BC (reference ``bcs.py:291-310``): the grid stores BOTH
    endpoints of a periodic axis, the same torus node. Row 0 is
    authoritative (the implicit solve runs on the reduced torus and
    restores row ``n-1`` from row 0), so applying copies row 0 onto row
    ``n-1``; the lower face is a no-op."""

    def _apply_one(self, var, grid, d, val=None):
        a = self._bc_face_dim
        if self._bc_n_dir > 0:
            var[(d,) + _face_index(a, -1, 0)] = _row(var, d, a, 0)


# -- configuration helpers (reference ``bcs.py:293-467``) -------------------


class BCContainer(TypedDict, total=False):
    bc_type: str
    bc_val: BC_val_type
    bc_val_opt: dict | None


class CylinderBoundary(NamedTuple):
    """Per-face BC setup for ``Cylinder`` domains (``bcs.py:301-328``)."""

    rl: BCContainer | None = None
    ru: BCContainer | None = None
    zl: BCContainer | None = None
    zu: BCContainer | None = None

    def __call__(self) -> list[BCConfig]:
        return _get_bc_dict(self, FDIR_RZ)


class BoxBoundary(NamedTuple):
    """Per-face BC setup for ``Box`` domains (``bcs.py:331-360``)."""

    xl: BCContainer | None = None
    xu: BCContainer | None = None
    yl: BCContainer | None = None
    yu: BCContainer | None = None
    zl: BCContainer | None = None
    zu: BCContainer | None = None

    def __call__(self) -> list[BCConfig]:
        return _get_bc_dict(self, FDIR)


def _get_bc_dict(bc_config, fdir: list[str]) -> list[BCConfig]:
    config: list[BCConfig] = []
    for face in fdir:
        bc_dict = getattr(bc_config, face)
        if bc_dict is not None:
            config.append(
                {
                    "bc_face": face,
                    "bc_type": bc_dict["bc_type"],
                    "bc_val": bc_dict["bc_val"],
                    "bc_val_opt": bc_dict.get("bc_val_opt"),
                }
            )
    return config


def mixed_bcs(bc_val: list, bc_type: list[str]) -> list[BCConfig]:
    """Per-face values/types in FDIR order (``bcs.py:385-408``).
    Box domains only."""
    return [
        {"bc_face": FDIR[i], "bc_type": t, "bc_val": v, "bc_val_opt": None}
        for i, (v, t) in enumerate(zip(bc_val, bc_type))
    ]


def homogeneous_bcs(dim: int, bc_val, bc_type: str) -> list[BCConfig]:
    """Same BC on every face (``bcs.py:411-440``). Box domains only."""
    return [
        {
            "bc_face": FDIR[i],
            "bc_type": bc_type,
            "bc_val": bc_val[i] if isinstance(bc_val, list) else bc_val,
            "bc_val_opt": None,
        }
        for i in range(dim * 2)
    ]


class BC_HD:
    """Homogeneous Dirichlet shorthand (``bcs.py:443-447``)."""

    def __new__(cls, dim: int, bc_val: float):
        return homogeneous_bcs(dim, bc_val, "dirichlet")


class BC_HN:
    """Homogeneous Neumann shorthand (``bcs.py:450-454``)."""

    def __new__(cls, dim: int, bc_val: float):
        return homogeneous_bcs(dim, bc_val, "neumann")


class ObstacleDirichlet:
    """Dirichlet condition on an interior obstacle mask (immersed-boundary
    style: the masked cells are pinned to the value and leave the Krylov
    solve's active set; JAX ``bcs.py:400-465``).

    ``dynamic=True`` (a moving body): the mask is read again on every
    solve call (``stream_values``), so assigning a new ``bc_mask`` between
    solves moves the body; a static obstacle uploads its mask once per
    device."""

    def __init__(self, bc_id: str, bc_val, bc_mask, bc_val_opt=None, dynamic: bool = False):
        self.bc_id = bc_id
        self.bc_val = bc_val
        self.bc_val_opt = bc_val_opt
        self.bc_mask = bc_mask
        self.bc_type = "obstacle_dirichlet"
        self.bc_face = "obstacle"
        self.bc_face_dim = -1
        self.bc_n_dir = 0
        self.bc_treat = False
        self.dynamic = bool(dynamic)

    @property
    def bc_mask(self) -> np.ndarray:
        return self._bc_mask

    @bc_mask.setter
    def bc_mask(self, m) -> None:
        self._bc_mask = np.asarray(m, dtype=bool)
        self._dev: dict = {}

    def mask_on(self, device) -> torch.Tensor:
        """The mask as a bool tensor on ``device`` (uploaded once)."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self._bc_mask, device=device)
        return self._dev[key]

    def block_mask(self, lay):
        """The mask as a block vector ``(1, *grid)`` of ``lay`` (each block's
        cut on its device; kept per layout for a static body, looked up by
        content for a dynamic one, whose mask changes between calls)."""
        return _block_mask(self._bc_mask, lay, None if self.dynamic else self._dev)

    def stream_blocks(self, var, grid, lay):
        """``stream_values`` for a solve on the blocks of ``lay``: the
        dynamic body's mask of this call as a block vector (``block_mask``)
        and its value; ``None`` for a static one."""
        if not self.dynamic:
            return None
        return self.block_mask(lay), self._resolved_val(var, grid)

    @property
    def type(self) -> str:
        return self.bc_type

    @property
    def streamable(self) -> bool:
        return self.dynamic

    def _resolved_val(self, var, grid):
        v = self.bc_val
        if callable(v):
            return torch.as_tensor(v(grid, self.bc_mask, var, self.bc_val_opt),
                                   dtype=var.dtype, device=var.device)
        if isinstance(v, (int, float)):
            return float(v)
        return torch.as_tensor(v, dtype=var.dtype, device=var.device)

    def stream_values(self, var: torch.Tensor, grid, t=None):
        """``(mask, value)`` of a dynamic obstacle, read from ``bc_mask``
        now (the device mask kept by content; ``None`` for a static
        one)."""
        if not self.dynamic:
            return None
        return device_array(self._bc_mask, device=var.device), self._resolved_val(var, grid)

    def apply(self, var: torch.Tensor, grid, var_dim: int | None = None, vals=None) -> torch.Tensor:
        return self.apply_(var.clone(), grid, var_dim, vals)

    def apply_(self, var: torch.Tensor, grid, var_dim: int | None = None, vals=None) -> torch.Tensor:
        """Pin the masked cells of ``var`` to the value, in place (a block
        vector block by block, the mask a block vector too)."""
        blocks = _blocks_mod()
        if isinstance(var, blocks.BlockTensor):
            lay = var.placement
            mask, val = vals if vals is not None else (self.block_mask(lay),
                                                       self._resolved_val(var, grid))
            for b, part in enumerate(var.parts):
                v = val
                if isinstance(val, torch.Tensor):  # cut to the block, on its device
                    v = blocks.transfer(val[lay.index(val.shape, b)] if val.dim() else val,
                                        part.device)
                self._pin(part, mask.parts[b][0], v, var_dim)
            return var
        if vals is not None:
            mask, val = vals
        else:
            mask, val = self.mask_on(var.device), self._resolved_val(var, grid)
        return self._pin(var, mask, val, var_dim)

    @staticmethod
    def _pin(var, mask, val, var_dim):
        for d in range(var.shape[0]) if var_dim is None else [var_dim]:
            if isinstance(val, float):
                var[d].masked_fill_(mask, val)
            else:
                vd = val[d] if val.ndim > var.ndim - 1 else val
                var[d] = torch.where(mask, vd, var[d])
        return var


class ObstacleNeumann:
    """Neumann (flux) condition on an interior obstacle (JAX
    ``bcs.py:468-598``).

    The obstacle's surface-shell cells take the second-order one-sided
    extrapolation of their fluid-side neighbours (the 4/3 rule of the
    domain Neumann faces, outward normal from the body into the fluid):
    ``v_shell = (4 v1 - v2)/3 + (2/3) V dx``. The whole solid body leaves
    the Krylov active set; the linear part (``apply_linear``) is folded
    into the operator applied to search directions, and the affine shift
    of a nonzero flux (``affine_field``) moves to the solve's RHS. Shell
    cells shared by two faces take the value of the face applied last
    (faces in the mesh's ``o_mask`` order: xl, xu, yl, yu, zl, zu).

    Args:
        faces: list of ``(shell_mask, axis, shift, dx)``; ``shift`` is the
            ``torch.roll`` amount that brings the fluid neighbour onto the
            shell cell (+1 for a lower face, -1 for an upper face).
        body_mask: the filled solid mask (``Mesh.obstacle_body_masks``).
        all_body_masks: every obstacle's filled mask; when given, the
            construction checks that each face's 1- and 2-step sources are
            fluid cells inside the grid, and raises ``ValueError`` for a
            shell within two cells of the domain boundary or bodies too
            close together (``bcs.py:518-535``).
    """

    def __init__(self, bc_id: str, bc_val, faces, body_mask, all_body_masks=None):
        self.bc_id = bc_id
        self.bc_val = float(bc_val)
        self.bc_val_opt = None
        self.faces = faces
        self.bc_mask = np.asarray(body_mask, dtype=bool)
        if all_body_masks is not None:
            solid = np.zeros_like(self.bc_mask)
            for m in all_body_masks:
                solid |= np.asarray(m, dtype=bool)
            for mask, axis, shift, _dx in self.faces:
                n = mask.shape[axis]
                pos = np.nonzero(mask)[axis]
                # apply() reads var at (shell - k * shift) for k = 1, 2
                for k in (1, 2):
                    src = pos - k * shift
                    if ((src < 0) | (src >= n)).any():
                        raise ValueError(
                            f"obstacle neumann {bc_id}: shell cells are within {k} cells of the "
                            f"domain boundary along axis {axis}; the one-sided extrapolation "
                            "would wrap around the grid."
                        )
                    if (np.roll(mask, -k * shift, axis) & solid).any():
                        raise ValueError(
                            f"obstacle neumann {bc_id}: the {k}-step extrapolation source along "
                            f"axis {axis} lies inside a solid body (bodies too thin or too close "
                            "together for the 4/3 shell rule)."
                        )
        self.bc_type = "obstacle_neumann"
        self.bc_face = "obstacle"
        self.bc_face_dim = -1
        self.bc_n_dir = 0
        self.bc_treat = False
        self.streamable = False

    @property
    def faces(self) -> list:
        return self._faces

    @faces.setter
    def faces(self, faces) -> None:
        self._faces = [(np.asarray(m, dtype=bool), int(ax), int(sh), float(dx))
                       for (m, ax, sh, dx) in faces]
        self._dev: dict = {}
        self._plans = self._gather_plans()

    @property
    def bc_mask(self) -> np.ndarray:
        return self._bc_mask

    @bc_mask.setter
    def bc_mask(self, m) -> None:
        self._bc_mask = np.asarray(m, dtype=bool)
        self._dev = {}

    def mask_on(self, device) -> torch.Tensor:
        """The body mask as a bool tensor on ``device`` (uploaded once)."""
        key = ("mask", str(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self._bc_mask, device=device)
        return self._dev[key]

    def block_mask(self, lay):
        """The body mask as a block vector of ``lay`` (kept per layout)."""
        return _block_mask(self._bc_mask, lay, self._dev)

    def _block_plans(self, lay) -> list:
        """``_plans`` cut to the blocks of ``lay`` (kept per layout): per plan,
        per block, None where the block holds no shell cell of it, else
        ``(dst, pos1, pos2, scale, fetch)``. ``dst`` are the flat indices of
        the block's shell cells, ``fetch`` lists ``(block, flat indices)``
        of the source cells to read, the block's own first and then each
        neighbour's that holds some (on that block's device: only those
        cells are copied), and ``pos1`` / ``pos2`` index each cell's 1- and
        2-step source into their concatenation."""
        key = ("plans", id(lay))
        if key in self._dev:
            return self._dev[key][1]
        grid = lay.grid
        bshape = [tuple(s.stop - s.start for s in sl) for _, sl, _ in lay.blocks]
        # the block coordinate of each node along every axis
        own = []
        for j, n in enumerate(grid):
            starts = sorted({sl[j].start for _, sl, _ in lay.blocks})
            own.append(np.searchsorted(starts, np.arange(n), side="right") - 1)
        coord_to_b = {c: b for b, (c, _, _) in enumerate(lay.blocks)}

        def locate(flat):
            idx = np.unravel_index(flat, grid)
            coords = np.stack([own[j][i] for j, i in enumerate(idx)], axis=1)
            b = np.array([coord_to_b[tuple(c)] for c in coords.tolist()], dtype=np.int64)
            loc = np.empty(flat.shape, dtype=np.int64)
            for k in np.unique(b):
                sel = b == k
                sl = lay.blocks[k][1]
                loc[sel] = np.ravel_multi_index(
                    tuple(i[sel] - s.start for i, s in zip(idx, sl)), bshape[k])
            return b, loc

        out = []
        for dst, src1, src2, scale in self._plans:
            bd, ld = locate(dst)
            (b1, l1), (b2, l2) = locate(src1), locate(src2)
            per = []
            for b, (_, _, dev) in enumerate(lay.blocks):
                sel = bd == b
                if not sel.any():
                    per.append(None)
                    continue
                srcs = np.concatenate([np.stack([b1[sel], l1[sel]], 1),
                                       np.stack([b2[sel], l2[sel]], 1)])
                owners = [b] + sorted(set(srcs[:, 0].tolist()) - {b})
                fetch, base, where = [], 0, {}
                for o in owners:
                    cells = np.unique(srcs[srcs[:, 0] == o, 1])
                    if cells.size:
                        fetch.append((o, torch.as_tensor(cells, device=lay.blocks[o][2])))
                        where[o] = (cells, base)
                        base += cells.size

                def pos(bs, ls, where=where, dev=dev):
                    p = np.empty(bs.shape, dtype=np.int64)
                    for o, (cells, off) in where.items():
                        m = bs == o
                        p[m] = off + np.searchsorted(cells, ls[m])
                    return torch.as_tensor(p, device=dev)

                per.append((torch.as_tensor(ld[sel], device=dev), pos(b1[sel], l1[sel]),
                            pos(b2[sel], l2[sel]), torch.as_tensor(scale[sel], device=dev),
                            fetch))
            out.append(per)
        self._dev[key] = (lay, out)
        return out

    def _gather_plans(self) -> list:
        """The shell update as gathers and scatters over the flattened grid:
        per plan, the flat indices of its shell cells, of their 1- and
        2-step sources (with ``roll``'s wrap) and each cell's affine shift
        ``(2/3) V dx``. One merged plan (the last face's entry where faces
        share a cell) when no source is itself a shell cell; else one plan
        per face, applied in the faces' order."""
        plans = []
        for mask, axis, shift, dx in self._faces:
            pos = np.nonzero(mask)
            srcs = []
            for k in (1, 2):
                moved = list(pos)
                moved[axis] = (pos[axis] - k * shift) % mask.shape[axis]
                srcs.append(np.ravel_multi_index(tuple(moved), mask.shape))
            dst = np.ravel_multi_index(pos, mask.shape)
            plans.append((dst, *srcs, np.full(dst.shape, (2.0 / 3.0) * self.bc_val * dx)))
        if len(plans) < 2:
            return plans
        dst, src1, src2, scale = (np.concatenate(a) for a in zip(*plans))
        if np.isin(np.concatenate([src1, src2]), dst).any():
            return plans
        _, last = np.unique(dst[::-1], return_index=True)
        keep = np.sort(len(dst) - 1 - last)  # the last face's entry of each cell
        return [(dst[keep], src1[keep], src2[keep], scale[keep])]

    def _plans_on(self, device) -> list:
        key = ("plans", str(device))
        if key not in self._dev:
            self._dev[key] = [tuple(torch.as_tensor(a, device=device) for a in plan)
                              for plan in self._plans]
        return self._dev[key]

    @property
    def type(self) -> str:
        return self.bc_type

    def stream_values(self, var, grid, t=None):
        return None

    def _shells(self, var: torch.Tensor, shift_val: bool, out=None) -> torch.Tensor:
        """``var`` with the shell cells extrapolated (into ``out`` when
        given, else a new tensor): per cell ``(4 v1 - v2) / 3`` of its
        fluid-side neighbours, ``+ (2/3) V dx`` with ``shift_val``."""
        if out is None:
            out = var.clone()
        if isinstance(out, _blocks_mod().BlockTensor):
            return self._shells_blocks(out, shift_val)
        flat = out.view(out.shape[0], -1)
        for dst, src1, src2, scale in self._plans_on(out.device):
            new = (4.0 * flat[:, src1] - flat[:, src2]) / 3.0
            if shift_val and self.bc_val != 0.0:
                new = new + scale.to(new.dtype)
            flat[:, dst] = new
        return out

    def _shells_blocks(self, out, shift_val: bool):
        """``_shells`` on a block vector, in place, plan by plan: every
        block reads its plan's sources (its own cells and the few its
        neighbours hold, copied from their devices) before any block
        writes, as the whole tensor's gather precedes its scatter."""
        c = out.shape[0]
        for plan in self._block_plans(out.placement):
            news = []
            for b, bp in enumerate(plan):
                if bp is None:
                    continue
                dst, pos1, pos2, scale, fetch = bp
                dev = out.parts[b].device
                blocks = _blocks_mod()
                pool = torch.cat([blocks.transfer(out.parts[o].view(c, -1)[:, cells], dev)
                                  for o, cells in fetch], dim=1)
                new = (4.0 * pool[:, pos1] - pool[:, pos2]) / 3.0
                if shift_val and self.bc_val != 0.0:
                    new = new + scale.to(new.dtype)
                news.append((b, dst, new))
            for b, dst, new in news:
                out.parts[b].view(c, -1)[:, dst] = new
        return out

    def apply(self, var: torch.Tensor, grid, var_dim: int | None = None, vals=None) -> torch.Tensor:
        return self._shells(var, True)

    def apply_(self, var: torch.Tensor, grid, var_dim: int | None = None, vals=None) -> torch.Tensor:
        """The shell extrapolation written into ``var`` (every component)."""
        return self._shells(var, True, out=var)

    def apply_linear(self, var: torch.Tensor, grid=None, var_dim: int | None = None) -> torch.Tensor:
        """The linear (zero-flux) part of ``apply``, as a new tensor: folded
        into the operator for Krylov search directions."""
        return self._shells(var, False)

    def affine_field(self, shape, dtype, device) -> torch.Tensor:
        """The affine shift ``e``: zeros with ``(2/3) V dx`` on each face's
        shell (last face wins at edges, as in ``apply``). The solve
        eliminates it by ``rhs -= A(e)``. ``device`` a ``blocks.Layout``:
        a block vector of it, made block by block."""
        blocks = _blocks_mod()
        if isinstance(device, blocks.Layout):
            lay = device
            parts = [torch.zeros((shape[0], *(s.stop - s.start for s in sl)), dtype=dtype,
                                 device=dev) for _, sl, dev in lay.blocks]
            if self.bc_val != 0.0:
                for plan in self._block_plans(lay):
                    for b, bp in enumerate(plan):
                        if bp is not None:
                            parts[b].view(shape[0], -1)[:, bp[0]] = bp[3].to(dtype)
            return blocks.BlockTensor(parts, lay, tuple(shape))
        e = torch.zeros(shape, dtype=dtype, device=device)
        if self.bc_val == 0.0:
            return e
        flat = e.view(shape[0], -1)
        for dst, _src1, _src2, scale in self._plans_on(device):
            flat[:, dst] = scale.to(dtype)
        return e


BC_type = Dirichlet | Neumann | Symmetry | Periodic | ObstacleDirichlet | ObstacleNeumann

BC_FACTORY: dict[str, type] = {
    "dirichlet": Dirichlet,
    "neumann": Neumann,
    "symmetry": Symmetry,
    "periodic": Periodic,
}


def apply_bcs_fn(bcs: list[BC_type], grid) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build a pure ``x -> x`` function applying all BCs in order (reference
    ``_apply_bc_otf``, ``linalg.py:282-299``). One clone per call; the BCs
    then write face rows of the clone in place (``inplace=True``: of ``x``
    itself, no clone)."""

    def apply_all(x: torch.Tensor, bc_vals=None, inplace: bool = False) -> torch.Tensor:
        if not inplace:
            x = x.clone()
        for i, bc in enumerate(bcs):
            bc.apply_(x, grid, vals=None if bc_vals is None else bc_vals[i])
        return x

    return apply_all
