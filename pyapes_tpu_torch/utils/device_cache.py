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
# per-block coefficient slices of a placed decomposition, by the vectors'
# identities (held) and the placement
_BLOCKS: OrderedDict = OrderedDict()
_BLOCKS_MAX = 64
# copies of tensors on other devices (the eigen-factors of a placed
# fastdiag), by the tensors' identities (held) and the device
_COPIES: OrderedDict = OrderedDict()
_COPIES_MAX = 64


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
    _BLOCKS.clear()
    _COPIES.clear()


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


def block_coeffs(coeffs, layout) -> list:
    """Per block of ``layout`` (a placed decomposition's ``blocks.Layout``),
    the per-axis coefficient vectors ``coeffs`` (1-D, global) cut to the
    block's index ranges and on the block's device, as frozen tuples: made
    at the first call of these vectors (by identity; the source vectors are
    held, so no identity is reused while the entry lives) on this
    placement, then the same objects (each block's kernel keeps its launch
    plan). Least recently used out beyond ``_BLOCKS_MAX``."""
    key = (tuple(id(c) for cs in coeffs for c in cs), id(layout))
    hit = _BLOCKS.get(key)
    if hit is None:
        per = [tuple(tuple(c[s].to(dev).contiguous() for c in cs) for cs, s in zip(coeffs, sl))
               for _, sl, dev in layout.blocks]
        hit = (coeffs, layout, per)
        _BLOCKS[key] = hit
        while len(_BLOCKS) > _BLOCKS_MAX:
            _BLOCKS.popitem(last=False)
    _BLOCKS.move_to_end(key)
    keep_alive(hit)  # a graph that reads them outlives an eviction
    return hit[2]


def per_solve(t, key, make):
    """``make()`` kept on the operand ``t`` under ``key``: the per-block
    copies a placed solve derives from an operand it scattered at entry (Γ,
    the advector: their halo-extended blocks, their neighbours' faces) are
    made at the first use and live as long as the operand, which is the
    solve's; nothing grid-sized is made inside its Krylov loop."""
    cache = t.__dict__.setdefault("_per_solve", {})
    if key not in cache:
        cache[key] = make()
    return cache[key]


def device_copies(tensors, devices) -> dict:
    """``{device: tensors on it}`` for each of ``devices``: the tuple
    ``tensors`` itself on its own device, a contiguous copy on another,
    made at the first call of these tensors (by identity; they are held,
    so no identity is reused while the entry lives) and device, then the
    same objects. Least recently used out beyond ``_COPIES_MAX``."""
    tensors = tuple(tensors)
    out = {}
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        if all(t.device == dev for t in tensors):
            out[dev] = tensors
            continue
        key = (tuple(id(t) for t in tensors), str(dev))
        hit = _COPIES.get(key)
        if hit is None:
            hit = (tensors, tuple(t.to(dev).contiguous() for t in tensors))
            _COPIES[key] = hit
            while len(_COPIES) > _COPIES_MAX:
                _COPIES.popitem(last=False)
        _COPIES.move_to_end(key)
        out[dev] = hit[1]
    return out
