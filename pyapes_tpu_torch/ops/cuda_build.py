"""Build and load the port's hand-written Hopper kernels.

Every ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh``) is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. A build
is keyed by the hash of its source and flags, written atomically into the
gitignored ``build/`` directory, and made at first use, so a fresh
checkout needs nothing but ``nvcc``. ``build_all()`` starts one ``nvcc``
per source at once (``chip_smoke.py`` builds everything that way).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("axis_stencil", "jacobi3d")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Build(NamedTuple):
    path: Path
    seconds: float
    """Compile time of this call (0.0 when the library was already built)."""
    log: str
    """nvcc/ptxas output (registers, spills) of a fresh build, else ''."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuda_build: nvcc not found (PATH or $CUDA_HOME/bin)")


def _target(name: str) -> tuple[Path, Path]:
    if name not in SOURCES:
        raise ValueError(f"cuda_build: unknown kernel source {name!r}")
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared helpers it includes
        key.update(header.read_bytes())
    return src, BUILD_DIR / f"{name}_{key.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    ``(lib, proc_or_None, tmp, tic)``."""
    src, lib = _target(name)
    if lib.exists():
        return lib, None, None, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return lib, proc, tmp, time.perf_counter()


def _finish(name: str, lib: Path, proc, tmp: Path, tic: float) -> Build:
    if proc is None:
        return Build(lib, 0.0, "")
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"cuda_build: nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return Build(lib, time.perf_counter() - tic, log)


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless its keyed library is built."""
    return _finish(name, *_start(name))


def build_all() -> dict[str, Build]:
    """Build every source, one ``nvcc`` each, all started together."""
    started = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, *s) for name, s in started.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built at first use), with
    the shared ``pyapes_cuda_error_string`` entry point typed."""
    lib = ctypes.CDLL(str(build(name).path))
    lib.pyapes_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pyapes_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.pyapes_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: kernel launch failed: {msg} ({err})")
