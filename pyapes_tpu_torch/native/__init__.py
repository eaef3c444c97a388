"""Native (C++) host-side tier (port of ``pyapes_tpu/native``): an
independent stencil oracle, binary snapshot IO with CRC32 integrity, and
the legacy-VTK writer ``utils/io.py`` calls.

``pyapes_native.cpp`` is compiled with ``g++`` at first use into the
repository's ``build/`` directory (beside the kernel libraries of
``ops/cuda_build.py``), named by a hash of the source and the flags and
written atomically. Without a compiler ``load()`` returns None and every
entry point takes its numpy path, which writes the same bytes (the
snapshot's CRC is zlib's CRC-32, the same IEEE polynomial). This is host
I/O: nothing here touches the card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("pyapes_native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_MAGIC = 0x50594150  # "PYAP", the C++ kMagic


def _build_lib() -> Path | None:
    """The built library (building it unless its keyed file exists), or
    None when there is no ``g++`` or the build fails."""
    key = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"pyapes_native_{key}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    path = _build_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.stencil_apply_ref.argtypes = [P, P, P, I, P, P, P]
    lib.stencil_apply_ref.restype = None
    lib.snapshot_write.argtypes = [ctypes.c_char_p, P, P, I, I]
    lib.snapshot_write.restype = I
    lib.snapshot_read.argtypes = [ctypes.c_char_p, P, P, P, P]
    lib.snapshot_read.restype = I
    lib.crc32_buf.argtypes = [P, ctypes.c_uint64, ctypes.c_uint32]
    lib.crc32_buf.restype = ctypes.c_uint32
    lib.vtk_write_rectilinear.argtypes = [ctypes.c_char_p, P, I64, P, I64, P, I64, P, P, I]
    lib.vtk_write_rectilinear.restype = I
    return lib


def available() -> bool:
    return load() is not None


def _host(a) -> np.ndarray:
    """A float64 host copy of a tensor or array (one copy per operand)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


def stencil_apply_ref(coeffs, x) -> np.ndarray:
    """Independent C++ oracle for the per-axis ``(ap, ac, am)`` stencil
    (the semantics of ``ops.stencil.apply_axis_stencil`` for one component,
    wrap-around neighbours); ``coeffs`` and ``x`` tensors or arrays."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++)")
    x = _host(x)
    ndim = x.ndim
    out = np.empty_like(x)
    dims = (ctypes.c_int64 * ndim)(*x.shape)
    host = [[_host(c) for c in cs] for cs in coeffs]

    def ptrs(k):
        return (ctypes.c_void_p * ndim)(*[cs[k].ctypes.data for cs in host])

    lib.stencil_apply_ref(x.ctypes.data, out.ctypes.data, dims, ndim, ptrs(0), ptrs(1), ptrs(2))
    return out


def _header(shape, itemsize: int) -> bytes:
    return struct.pack(f"<Ii{len(shape)}qi", _MAGIC, len(shape), *shape, itemsize)


def snapshot_write(path: str, arr) -> None:
    """Write ``[magic][ndim][dims][itemsize][payload][crc32]`` (the C++
    layout); the numpy path writes the same bytes."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.itemsize not in (4, 8):
        raise ValueError(f"snapshot_write: itemsize {arr.dtype.itemsize} not in (4, 8)")
    lib = load()
    if lib is not None:
        dims = (ctypes.c_int64 * arr.ndim)(*arr.shape)
        rc = lib.snapshot_write(path.encode(), arr.ctypes.data, dims, arr.ndim,
                                arr.dtype.itemsize)
        if rc != 0:
            raise IOError(f"snapshot_write failed: rc={rc}")
        return
    payload = arr.tobytes()
    with open(path, "wb") as f:
        f.write(_header(arr.shape, arr.dtype.itemsize))
        f.write(payload)
        f.write(struct.pack("<I", zlib.crc32(payload)))


def snapshot_read(path: str, dtype) -> np.ndarray:
    """Read a snapshot back, checking its magic and CRC (``IOError`` on a
    mismatch)."""
    dtype = np.dtype(dtype)
    lib = load()
    if lib is not None:
        dims = (ctypes.c_int64 * 8)()
        ndim, itemsize = ctypes.c_int32(), ctypes.c_int32()
        args = (dims, ctypes.byref(ndim), ctypes.byref(itemsize))
        rc = lib.snapshot_read(path.encode(), None, *args)
        if rc != 0:
            raise IOError(f"snapshot_read header failed: rc={rc}")
        if dtype.itemsize != itemsize.value:
            raise ValueError(f"snapshot_read: itemsize {itemsize.value}, asked {dtype}")
        out = np.empty(tuple(dims[i] for i in range(ndim.value)), dtype=dtype)
        rc = lib.snapshot_read(path.encode(), out.ctypes.data, *args)
        if rc != 0:
            raise IOError(f"snapshot_read failed: rc={rc} (crc/format)")
        return out
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8 or struct.unpack_from("<I", raw)[0] != _MAGIC:
        raise IOError("snapshot_read: bad magic")
    (nd,) = struct.unpack_from("<i", raw, 4)
    if not 1 <= nd <= 8:
        raise IOError(f"snapshot_read: bad ndim {nd}")
    shape = struct.unpack_from(f"<{nd}q", raw, 8)
    (isz,) = struct.unpack_from("<i", raw, 8 + 8 * nd)
    if dtype.itemsize != isz:
        raise ValueError(f"snapshot_read: itemsize {isz}, asked {dtype}")
    start = 12 + 8 * nd
    nbytes = int(np.prod(shape, dtype=np.int64)) * isz
    if len(raw) != start + nbytes + 4:
        raise IOError("snapshot_read: truncated file")
    payload = raw[start:start + nbytes]
    if zlib.crc32(payload) != struct.unpack_from("<I", raw, start + nbytes)[0]:
        raise IOError("snapshot_read: crc mismatch")
    return np.frombuffer(payload, dtype=dtype).reshape(shape).copy()
