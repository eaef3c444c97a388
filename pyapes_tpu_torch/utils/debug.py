"""Numerical-health checks (port of ``pyapes_tpu/utils/debug.py``).

``validate_field`` and ``divergence_guard`` are host-side checks of a
field and of a solver report. ``checked(fn)`` is the counterpart of JAX's
``checkify(fn, errors=float_checks | nan_checks)``: it runs ``fn`` and
raises ``NaNError`` naming the FIRST operation whose floating output holds
a NaN (checkify's NaN rule, ``check_nans``: NaN only, not Inf, and only
for the operations that compute, the counterpart of checkify's
``nan_primitives`` — a creation, copy, view or select is not checked, so
a NaN-filled history buffer or an uninitialized ``empty`` is not flagged).

Two sources of operations are checked:

* every PyTorch operator, through a ``TorchDispatchMode`` that inspects
  its outputs;
* the hand-written CUDA kernels, which launch through ``ctypes`` and never
  pass the dispatcher: each wrapper reports its outputs under its own name
  (``record_kernel``) right after its launch, on its CUDA branch. On a CPU
  tensor a wrapper runs its plain version, whose operators the mode checks
  one by one (as checkify checks an interpreted Pallas kernel's body).

The check stays on the device: per checked output, one ``isnan``/``any``
pair writes a flag into a device buffer; the flags are read once, when the
checked region ends. A block vector of a placed decomposition
(``parallel.blocks.BlockTensor``) is checked block by block, each block's
flag on its own device (nothing is gathered); the block-level operators are
what gets named, as the whole tensor's would be. A checked run therefore
computes the same bits as an unchecked one; it costs one extra read of
every checked output and the launches of those reductions. A checked region cannot run inside a CUDA
graph capture (its end reads the flags back).
"""
from __future__ import annotations

import functools
import math
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# The operators that compute a value (and so can generate a NaN): the
# counterpart of checkify's ``nan_primitives``, by overload-packet name with
# an in-place ``_`` dropped.
_NAN_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "true_divide", "reciprocal", "addcmul", "addcdiv",
    "addmm", "addmv", "addbmm", "baddbmm", "mm", "bmm", "mv", "dot", "vdot", "matmul",
    "_addmm_activation", "sum", "mean", "prod", "cumsum", "cumprod", "var", "std",
    "linalg_vector_norm", "norm", "sqrt", "rsqrt", "pow", "float_power", "exp", "exp2", "expm1",
    "log", "log2", "log10", "log1p", "sin", "cos", "tan", "sinh", "cosh", "tanh", "asin",
    "acos", "atan", "atan2", "asinh", "acosh", "atanh", "erf", "erfc", "erfinv", "sigmoid",
    "lgamma", "digamma", "remainder", "fmod", "lerp", "logsumexp", "convolution",
    "_convolution",
})
_CHUNK = 4096  # flags per device buffer

_local = threading.local()


class NaNError(RuntimeError):
    """A checked region generated a NaN; ``op`` names the first operation
    that did (``aten.<op>.<overload>``, or a hand kernel's wrapper)."""

    def __init__(self, op: str, index: int, total: int):
        super().__init__(f"nan generated by operation: {op} (operation {index + 1} of {total} "
                         "checked).")
        self.op = op


def _checks() -> list:
    """The checked regions open on this thread, innermost last."""
    if not hasattr(_local, "checks"):
        _local.checks = []
    return _local.checks


class _NaNCheck(TorchDispatchMode):
    """Flags, on the device, which checked output held a NaN."""

    def __init__(self):
        super().__init__()
        self.names: list[str] = []
        self.flags: dict = {}  # device -> (flag buffers, op index of each flag)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__.rstrip("_") in _NAN_OPS:
            self.record(str(func), tree_leaves(out))
        return out

    def record(self, name: str, outs) -> None:
        op = len(self.names)
        self.names.append(name)
        for t in outs:
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
                continue
            # a block vector: one flag per block, on the block's device
            for p in getattr(t, "parts", (t,)):
                bufs, index = self.flags.setdefault(p.device, ([], []))
                pos = len(index)
                if pos % _CHUNK == 0:
                    bufs.append(torch.zeros(_CHUNK, dtype=torch.bool, device=p.device))
                torch.any(torch.isnan(p), out=bufs[-1][pos % _CHUNK])
                index.append(op)

    def first(self):
        """``(name, index)`` of the first operation that generated a NaN, or
        None: one read per device."""
        hits = []
        for bufs, index in self.flags.values():
            flags = torch.cat(bufs)[: len(index)]
            found, pos = torch.stack([flags.any().long(),
                                      flags.to(torch.uint8).argmax()]).tolist()
            if found:
                hits.append(index[pos])
        if not hits:
            return None
        return self.names[min(hits)], min(hits)


class nan_check:
    """Context manager: raise ``NaNError`` at its end when an operation
    inside generated a NaN (``checked`` wraps a function in it). An
    exception raised inside is chained to the ``NaNError`` when there was
    one."""

    def __enter__(self):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise ValueError("debug: a NaN-checked region cannot run inside a CUDA graph capture")
        self._mode = _NaNCheck()
        self._mode.__enter__()
        _checks().append(self._mode)
        return self

    def __exit__(self, exc_type, exc, tb):
        _checks().remove(self._mode)
        self._mode.__exit__(None, None, None)
        hit = self._mode.first()
        if hit is not None:
            raise NaNError(hit[0], hit[1], len(self._mode.names)) from exc
        return False


def record_kernel(name: str, *outputs) -> None:
    """Check a hand kernel's outputs under its wrapper's ``name`` in every
    open checked region (a no-op outside one)."""
    for mode in _checks():
        mode.record(name, outputs)


def validate_field(var, name: str | None = None) -> None:
    """Host-side: raise if a Field (or tensor) contains NaN/Inf (one host
    read)."""
    arr = torch.as_tensor(var() if hasattr(var, "bcs") else var)
    label = name or getattr(var, "name", None) or "array"
    n_bad = int((~torch.isfinite(arr)).sum())
    if n_bad:
        raise FloatingPointError(f"validate_field: {label} has {n_bad} non-finite values")


def checked(fn):
    """Wrap ``fn`` with the NaN check; the wrapper returns ``fn``'s result
    and raises ``NaNError`` naming the first operation that generated a NaN:

        >>> safe_solve = checked(solve_fn)
        >>> out = safe_solve(x, rhs)   # raises on internal NaN
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with nan_check():
            return fn(*args, **kwargs)

    return wrapper


def divergence_guard(report: dict, context: str = "solve") -> None:
    """Raise when a solver report signals divergence (mirrors the
    reference's RuntimeError on invalid tolerance, ``linalg.py:334-336``).
    ``tol`` may be a 0-d device tensor (a ``sync: False`` report): one read."""
    tol = report.get("tol", math.nan)
    tol = float(tol.item() if isinstance(tol, torch.Tensor) else tol)
    if not math.isfinite(tol):
        raise RuntimeError(f"{context}: diverged (tol={tol})")
