"""Mesh slicing helpers (reference ``pyapes/mesh/tools.py:7-32``)."""
from __future__ import annotations

import numpy as np
import torch

from pyapes_tpu_torch.geometry.basis import DIR_TO_NUM, DIR_TO_NUM_RZ, SIDE_TO_NUM


def boundary_slicer(dim: int, bcs, coord_sys: str = "xyz") -> tuple[slice, ...]:
    """Interior slicer that keeps boundary nodes only on periodic faces
    (reference ``tools.py:7-20``)."""
    slice_idx: list[list[int | None]] = [[1, -1] for _ in range(dim)]
    d2n = DIR_TO_NUM if coord_sys == "xyz" else DIR_TO_NUM_RZ

    for bc in bcs or []:
        if bc.bc_type == "periodic":
            d_idx = d2n[bc.bc_face[0]]
            s_idx = SIDE_TO_NUM[bc.bc_face[1]]
            slice_idx[d_idx][s_idx] = None

    return tuple(slice(*slice_idx[i]) for i in range(dim))


def inner_slicer(dim: int, pad: int | None = 1) -> tuple[slice, ...]:
    """Interior slicer with a uniform pad (reference ``tools.py:23-32``)."""
    return tuple(
        slice(pad, -pad if isinstance(pad, int) else None) for _ in range(dim)
    )


def interior_mask(nx: tuple[int, ...], slicer: tuple[slice, ...]) -> np.ndarray:
    """0/1 float64 host mask selecting the slicer region (JAX
    ``mesh/tools.py:31``)."""
    m = np.zeros(nx, dtype=np.float64)
    m[slicer] = 1.0
    return m


def interior_mask_device(
    nx: tuple[int, ...], slicer: tuple[slice, ...], dtype, device
) -> torch.Tensor:
    """The same mask built on ``device`` as the outer product of per-axis
    0/1 vectors (no full-grid host array is ever made or copied)."""
    m = None
    for j, s in enumerate(slicer):
        v = torch.zeros(nx[j], dtype=dtype, device=device)
        v[s] = 1.0
        shape = [1] * len(nx)
        shape[j] = -1
        v = v.reshape(shape)
        m = v if m is None else m * v
    return m.expand(nx).contiguous()
