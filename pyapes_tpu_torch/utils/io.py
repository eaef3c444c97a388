"""Visualization export: legacy-VTK rectilinear grids (ParaView/VisIt), port
of ``pyapes_tpu/utils/io.py``.

The native C++ writer (``native/pyapes_native.cpp``:
``vtk_write_rectilinear``, big-endian binary as the legacy format
requires) with a numpy path that writes the same bytes, a ``.pvd``
collection writer for time series, and a minimal reader. A field may be a
tensor on the card: it is copied to the host once, as float32.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from pyapes_tpu_torch import native


def _coords(mesh) -> list[np.ndarray]:
    cs = [np.asarray(x, dtype=np.float32) for x in mesh._x_np]
    while len(cs) < 3:
        cs.append(np.zeros(1, dtype=np.float32))
    return cs


def _host_f32(arr) -> np.ndarray:
    """One device-to-host copy of a tensor (cast to float32 on its device
    first), or a numpy view of an array."""
    if hasattr(arr, "detach"):
        import torch

        return arr.detach().to(torch.float32).cpu().numpy()
    return np.asarray(arr, dtype=np.float32)


def write_vtk(path: str, mesh, fields: dict) -> str:
    """Write scalar fields on the mesh to a legacy-VTK rectilinear grid.

    Args:
        path: output filename (``.vtk`` appended if missing).
        mesh: ``Mesh`` (1/2/3-D; missing axes are written flat).
        fields: ``{name: tensor or array}`` of shape ``(*nx)`` or
            ``(1, *nx)``.

    Returns the written path. VTK orders points x-fastest; the C-order
    arrays are transposed on write.
    """
    if not path.endswith(".vtk"):
        path = path + ".vtk"
    xs, ys, zs = _coords(mesh)
    prepared: list[tuple[str, np.ndarray]] = []
    for name, arr in fields.items():
        a = _host_f32(arr)
        if a.ndim == mesh.dim + 1 and a.shape[0] == 1:
            a = a[0]
        if a.shape != tuple(mesh.nx):
            raise ValueError(f"write_vtk: field {name} has shape {a.shape}, mesh {mesh.nx}")
        a = a.reshape(tuple(mesh.nx) + (1,) * (3 - mesh.dim))  # pad to 3-D
        prepared.append((str(name), np.ascontiguousarray(a)))

    lib = native.load()
    if lib is not None:
        names = (ctypes.c_char_p * len(prepared))(*[n.encode() for n, _ in prepared])
        ptrs = (ctypes.c_void_p * len(prepared))(*[a.ctypes.data for _, a in prepared])
        rc = lib.vtk_write_rectilinear(
            path.encode(), xs.ctypes.data, len(xs), ys.ctypes.data, len(ys),
            zs.ctypes.data, len(zs), names, ptrs, len(prepared))
        if rc == 0:
            return path
    # numpy path (identical bytes)
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\n")
        f.write(b"pyapes_tpu export\n")
        f.write(b"BINARY\n")
        f.write(b"DATASET RECTILINEAR_GRID\n")
        f.write(f"DIMENSIONS {len(xs)} {len(ys)} {len(zs)}\n".encode())
        for tag, c in (("X", xs), ("Y", ys), ("Z", zs)):
            f.write(f"{tag}_COORDINATES {len(c)} float\n".encode())
            f.write(c.astype(">f4").tobytes())
            f.write(b"\n")
        f.write(f"POINT_DATA {len(xs) * len(ys) * len(zs)}\n".encode())
        for name, a in prepared:
            f.write(f"SCALARS {name} float 1\n".encode())
            f.write(b"LOOKUP_TABLE default\n")
            # x-fastest: transpose (nx, ny, nz) -> (nz, ny, nx) C-order
            f.write(np.ascontiguousarray(a.T).astype(">f4").tobytes())
            f.write(b"\n")
    return path


def write_pvd(path: str, entries: list[tuple[float, str]]) -> str:
    """Write a ParaView ``.pvd`` collection referencing per-step files.

    Args:
        entries: ``[(time, filename), ...]`` — filenames are stored
            relative to the ``.pvd``'s directory.
    """
    if not path.endswith(".pvd"):
        path = path + ".pvd"
    base = os.path.dirname(os.path.abspath(path))
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="Collection" version="0.1" byte_order="BigEndian">',
        "  <Collection>",
    ]
    for t, fname in entries:
        rel = os.path.relpath(os.path.abspath(fname), base)
        lines.append(f'    <DataSet timestep="{t}" group="" part="0" file="{rel}"/>')
    lines += ["  </Collection>", "</VTKFile>", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def read_vtk(path: str) -> dict:
    """Minimal legacy-VTK rectilinear reader (round-trip validation, not a
    general parser). Returns ``{"coords": [x, y, z], "fields": {name: a}}``
    with numpy arrays back in C order ``(nx, ny, nz)``."""
    with open(path, "rb") as f:
        raw = f.read()

    def after(tag: bytes, start: int = 0) -> int:
        i = raw.index(tag, start)
        return raw.index(b"\n", i) + 1

    i = raw.index(b"DIMENSIONS")
    dims = [int(v) for v in raw[i:raw.index(b"\n", i)].split()[1:4]]
    coords = []
    pos = 0
    for tag in (b"X_COORDINATES", b"Y_COORDINATES", b"Z_COORDINATES"):
        pos = after(tag, pos)
        n = dims[len(coords)]
        coords.append(np.frombuffer(raw[pos:pos + 4 * n], dtype=">f4").astype(np.float32))
        pos += 4 * n
    fields = {}
    npts = dims[0] * dims[1] * dims[2]
    start = pos
    while True:
        try:
            i = raw.index(b"SCALARS", start)
        except ValueError:
            break
        name = raw[i:raw.index(b"\n", i)].split()[1].decode()
        pos = after(b"LOOKUP_TABLE", i)
        a = np.frombuffer(raw[pos:pos + 4 * npts], dtype=">f4")
        fields[name] = a.reshape(dims[2], dims[1], dims[0]).T.astype(np.float32)
        start = pos + 4 * npts
    return {"coords": coords, "fields": fields}
