"""Device constants kept across solves, keyed by content.

A solve builds some operands on the host (per-axis coefficient vectors,
row scales, BC values, obstacle masks). Uploading them on every call
costs a pageable host-to-device copy each, which synchronizes the host and
cannot be captured into a CUDA graph. These helpers upload an array once
per content, dtype and device and hand back the same tensor afterwards; a
scalar becomes a 0-d tensor made by a fill on the device, never a copy.
Under a graph capture nothing new is stored (a tensor made there holds no
value until the graph runs): the warm-up call fills the cache first. What
a capture takes from the cache is tied to its graph (``keep_alive``), so
an eviction never frees memory a graph still reads.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from pyapes_tpu_torch.ops.graph_loop import keep_alive

_CACHE: OrderedDict = OrderedDict()
_CACHE_MAX = 512
_BY_ID: dict = {}


def _capturing(device) -> bool:
    return torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing()


def _get(key, make):
    if key in _CACHE:
        _CACHE.move_to_end(key)
        t = _CACHE[key]
    else:
        t = make()
        if not _capturing(t.device):
            _CACHE[key] = t
            _BY_ID[id(t)] = t
            while len(_CACHE) > _CACHE_MAX:
                _BY_ID.pop(id(_CACHE.popitem(last=False)[1]), None)
    keep_alive(t)
    return t


def clear() -> None:
    """Drop every cached constant (a graph keeps those it reads)."""
    _CACHE.clear()
    _BY_ID.clear()


def device_array(a, dtype=None, device=None) -> torch.Tensor:
    """``a`` (a numpy array or nested sequence) as a contiguous tensor on
    ``device`` in ``dtype`` (numpy's dtype mapped when None), uploaded once
    per content."""
    a = np.asarray(a)
    key = ("array", a.dtype.str, a.shape, a.tobytes(), str(dtype), str(torch.device(device)))
    return _get(key, lambda: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                             device=device).contiguous())


def device_scalar(v, dtype, device) -> torch.Tensor:
    """The number ``v`` as a 0-d tensor of ``dtype`` on ``device``, made by
    a fill on the device (no host copy)."""
    key = ("scalar", float(v), str(dtype), str(torch.device(device)))
    return _get(key, lambda: torch.full((), float(v), dtype=dtype, device=device))


def device_coeffs(coeffs, device, dtype) -> tuple:
    """Per-axis coefficient vectors ``((ap, ac, am), ...)`` (host arrays) as
    contiguous 1-D tensors on ``device`` in ``dtype``, each uploaded once."""
    return tuple(tuple(device_array(c, dtype, device) for c in cs) for cs in coeffs)


def is_constant(t) -> bool:
    """Whether ``t`` is one of the cached constants (the same object)."""
    return _BY_ID.get(id(t)) is t
