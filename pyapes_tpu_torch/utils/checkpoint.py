"""Checkpoint / resume for Field state (port of
``pyapes_tpu/utils/checkpoint.py``).

State is the Field payload (``VAR``), its history (``VARo``, ``VARoo``)
and its clocks. Both backends write the JAX package's single-file layout:
an ``.npz`` with the keys ``<name>__VAR``, ``<name>__VARo`` and
``<name>__VARoo`` and a ``__pyapes_meta__`` JSON entry holding ``dim``,
``t``, ``dt`` and ``n_hist`` per field, so a checkpoint crosses between
the two packages both ways.

* ``save`` / ``load``: synchronous.
* ``save_orbax`` / ``load_orbax`` / ``wait_for_checkpoints``: the names of
  the JAX package's orbax pair, with its contract and without orbax. A
  non-blocking save snapshots the fields at the call: a device copy of
  each CUDA tensor on the current stream (so later writes to the field,
  in place too, never reach the snapshot), then a device-to-host copy of
  it into pinned memory on a side stream, marked by an event; a writer
  thread waits for the event and writes the same ``.npz``, overlapping
  the compute that follows. ``wait_for_checkpoints()`` (or the next
  ``save_orbax``) makes the write durable; ``load_orbax`` reads that file.

A Field whose value is a block vector of a placed decomposition
(``parallel.blocks.BlockTensor``) is written through the host gather (each
block copied to the host once, ``blocks.host_gathers``); loading into it
restores each level into its blocks, each block's slice copied from the
host straight to its device, as Orbax restores into the template's
sharding.

bfloat16 payloads are written as numpy writes the JAX package's
``ml_dtypes`` bfloat16, a raw 2-byte ``|V2`` array of the same bits, and
read back from it.
"""
from __future__ import annotations

import json
import threading

import numpy as np
import torch

from pyapes_tpu_torch.parallel import blocks

_META = "__pyapes_meta__"
_LEVELS = ("VAR", "VARo", "VARoo")


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _by_name(fields) -> dict:
    return {f.name: f for f in fields} if isinstance(fields, list) else dict(fields)


def _state(f) -> tuple:
    return f(), f.VARo, f.VARoo


def _meta(f) -> dict:
    return {"dim": f.dim, "t": float(f._t), "dt": None if f._dt is None else float(f._dt),
            "n_hist": int(f.n_hist)}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bfloat16 as its raw bits (``|V2``), the
    array numpy stores for an ``ml_dtypes`` bfloat16."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A stored array on ``like``'s device in ``like``'s dtype (on
    ``like``'s blocks for a block vector); a ``|V2`` array is read as
    bfloat16 bits."""
    if a.dtype.kind == "V":
        if a.dtype.itemsize != 2:
            raise TypeError(f"checkpoint: cannot read a stored {a.dtype} array")
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if isinstance(like, blocks.BlockTensor):
        return blocks.scatter(t.to(like.dtype), like.placement)
    return t.to(device=like.device, dtype=like.dtype)


def _write(path: str, arrays: dict, meta: dict) -> None:
    arrays = dict(arrays)
    arrays[_META] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8).copy()
    np.savez(_npz(path), **arrays)


def save(path: str, fields) -> None:
    """Save Fields to ``<path>.npz`` (values, old values, time state)."""
    arrays, meta = {}, {}
    for name, f in _by_name(fields).items():
        for level, t in zip(_LEVELS, _state(f)):
            arrays[f"{name}__{level}"] = _to_numpy(t.detach().cpu())
        meta[name] = _meta(f)
    _write(path, arrays, meta)


def _restore(f, name: str, data, meta: dict) -> None:
    like = f()
    f._VAR = _from_numpy(data[f"{name}__VAR"], like)
    f._VARo = _from_numpy(data[f"{name}__VARo"], like)
    if f"{name}__VARoo" in data:  # absent in the JAX package's oldest checkpoints
        f._VARoo = _from_numpy(data[f"{name}__VARoo"], like)
    f._n_hist = int(meta[name].get("n_hist", 0))
    f._t = meta[name]["t"]
    f._dt = meta[name]["dt"]


def load(path: str, fields) -> None:
    """Restore Field payloads from ``save`` output, each onto its field's
    own device and dtype. The fields are rebound to new tensors: a fused
    runner that captured before the load copies them into its graph's
    state at its next replay."""
    path = _npz(path)
    with np.load(path) as data:
        meta = json.loads(bytes(data[_META]).decode())
        for name, f in _by_name(fields).items():
            if name not in meta:
                raise KeyError(f"checkpoint: field {name} not found in {path}")
            _restore(f, name, data, meta)


class _AsyncWriter:
    """The pending non-blocking saves: one writer thread each, and the
    first error any of them met."""

    def __init__(self):
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._error: BaseException | None = None

    def submit(self, path: str, snaps: dict, meta: dict, event) -> None:
        def run():
            try:
                if event is not None:
                    event.synchronize()
                _write(path, {k: _to_numpy(v) for k, v in snaps.items()}, meta)
            except BaseException as e:  # re-raised by wait()
                with self._lock:
                    self._error = self._error or e

        th = threading.Thread(target=run, name="pyapes-checkpoint", daemon=True)
        with self._lock:
            self._threads.append(th)
        th.start()

    def wait(self) -> None:
        with self._lock:
            threads, self._threads = self._threads, []
        for th in threads:
            th.join()
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err


_WRITER = _AsyncWriter()


def _snapshot(tensors: dict):
    """Host copies of ``tensors`` as they are now: ``(host tensors, event
    or None)``. CUDA tensors: a device copy on the current stream, then a
    copy into pinned host memory on a side stream, the event recorded
    after it."""
    # block vectors through the host gather, now (their blocks may lie on
    # several devices)
    gathered = {k: blocks.host_gather(t) for k, t in tensors.items()
                if isinstance(t, blocks.BlockTensor)}
    tensors = {k: t for k, t in tensors.items() if k not in gathered}
    cuda = [t for t in tensors.values() if t.is_cuda]
    if not cuda:
        return {**{k: t.detach().clone() for k, t in tensors.items()}, **gathered}, None
    device = cuda[0].device
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    dev_copies = {k: t.detach().clone() for k, t in tensors.items() if t.is_cuda}
    side.wait_stream(current)
    host = {k: t.detach().clone() for k, t in tensors.items() if not t.is_cuda}
    host.update(gathered)
    with torch.cuda.stream(side):
        for k, t in dev_copies.items():
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t.record_stream(side)  # the allocator keeps it until the copy is done
            host[k] = h
    event = torch.cuda.Event()
    event.record(side)
    return host, event


def save_orbax(path: str, fields, block: bool = True) -> None:
    """Save Fields to ``<path>.npz`` in ``save``'s layout; ``block=False``
    returns once the state is snapshotted and writes on a thread (the
    module docstring). Serializes on the previous non-blocking save."""
    _WRITER.wait()
    tensors, meta = {}, {}
    for name, f in _by_name(fields).items():
        for level, t in zip(_LEVELS, _state(f)):
            tensors[f"{name}__{level}"] = t
        meta[name] = _meta(f)
    snaps, event = _snapshot(tensors)
    _WRITER.submit(path, snaps, meta, event)
    if block:
        _WRITER.wait()


def wait_for_checkpoints() -> None:
    """Block until all pending non-blocking ``save_orbax`` writes are
    durable; raises the first error a write met."""
    _WRITER.wait()


def load_orbax(path: str, fields) -> None:
    """Restore Fields from ``save_orbax`` output (see ``load``)."""
    load(path, fields)
