"""Build and load the port's hand-written Hopper kernels.

Every library ``<name>`` is built from its translation units (``UNITS``:
by default ``csrc/<name>.cu`` alone; the axis-stencil library also from
``csrc/axis_march2d.cu`` (the row march of 2-D grids) and from
``csrc/axis_march.cu`` once per storage dtype and radius and once per
storage dtype for each of its alpha-dot and halo-extended instances,
the variable-Γ library from ``csrc/diff_march.cu`` once per storage
dtype and Γ layout,
the advection library from ``csrc/advect_march.cu`` once per storage dtype),
each with the shared ``csrc/*.cuh``, compiled by ``nvcc`` for ``sm_90a``
(one ``nvcc`` per unit, all started together) and linked into a shared
library with a plain C interface, loaded with ``ctypes``. A build is keyed by the hash of
its sources, headers and flags, written atomically into the gitignored
``build/`` directory, and made at first use, so a fresh checkout needs
nothing but ``nvcc``. ``build_all()`` starts every unit of every library
at once (``chip_smoke.py`` builds everything that way).
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
SOURCES = ("axis_stencil", "jacobi3d", "diff_field", "advect", "graph_loop", "peer")
# the libraries of more than one unit: (source stem, its own nvcc flags)
UNITS = {
    "axis_stencil": (("axis_stencil", ()), ("axis_march2d", ())) + tuple(
        ("axis_march", (f"-DAM_DTYPE={dtype}", f"-DAM_R={radius}"))
        for dtype in (2, 0, 1) for radius in (1, 2)) + tuple(
        ("axis_march", (f"-DAM_DTYPE={dtype}", "-DAM_R=1", f"-DAM_KIND={kind}"))
        for dtype in (2, 0, 1) for kind in (1, 2)),
    "diff_field": (("diff_field", ()),) + tuple(
        ("diff_march", (f"-DVG_DTYPE={dtype}", f"-DVG_ISO={iso}"))
        for dtype in (2, 0, 1) for iso in (1, 0)),
    "advect": (("advect", ()),) + tuple(
        ("advect_march", (f"-DAV_DTYPE={dtype}",)) for dtype in (2, 0, 1)),
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def _units(name: str) -> tuple:
    return UNITS.get(name, ((name, ()),))


def _target(name: str) -> Path:
    if name not in SOURCES:
        raise ValueError(f"cuda_build: unknown kernel source {name!r}")
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for stem, flags in _units(name):
        key.update((CSRC / f"{stem}.cu").read_bytes() + " ".join(flags).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared helpers they include
        key.update(header.read_bytes())
    return BUILD_DIR / f"{name}_{key.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one ``nvcc -c`` per unit of ``name`` unless its library
    exists; returns ``(lib, [(stem, object, proc)], tic)``."""
    lib = _target(name)
    if lib.exists():
        return lib, [], 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for u, (stem, flags) in enumerate(_units(name)):
        obj = lib.with_name(f"{lib.stem}.{u}.{os.getpid()}.o")
        procs.append((stem, obj, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(CSRC / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    return lib, procs, time.perf_counter()


def _finish(name: str, lib: Path, procs, tic: float) -> Build:
    if not procs:
        return Build(lib, 0.0, "")
    logs = [(stem, *p.communicate(), p.returncode) for stem, _, p in procs]
    for stem, log, _, rc in logs:
        if rc != 0:
            raise RuntimeError(f"cuda_build: nvcc failed on {stem}.cu:\n{log}")
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
                          capture_output=True, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"cuda_build: linking {name} failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return Build(lib, time.perf_counter() - tic, "".join(log for _, log, _, _ in logs))


def build(name: str) -> Build:
    """Compile and link the units of ``name`` unless its keyed library is
    built."""
    return _finish(name, *_start(name))


def build_all() -> dict[str, Build]:
    """Build every library, one ``nvcc`` per unit, all started together."""
    started = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, *s) for name, s in started.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (built at first use), with
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
