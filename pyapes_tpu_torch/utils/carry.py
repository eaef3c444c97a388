"""State carried across from the JAX package.

This system has no learned weights: its state is field values (with
their history levels ``VARo``/``VARoo`` for Ddt), per-axis coefficient
vectors, variable diffusivities Γ, advecting fields and
fast-diagonalization factors. These helpers turn
arrays of the JAX package (handed over as numpy) into the port's tensors,
so both packages can compute from the same state. The solver uses
``coeffs_from_numpy`` for its own host-built coefficient vectors too.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, like: torch.Tensor | None = None, device=None, dtype=None):
    if like is not None:
        device, dtype = like.device, like.dtype
    a = np.asarray(a)
    if not a.flags.writeable:  # a JAX array's host view: own a copy
        a = a.copy()
    return torch.as_tensor(a, dtype=dtype, device=device)


def field_from_numpy(field, var, varo=None, varoo=None):
    """Load ``var`` (and optionally the history levels ``varo``/``varoo``)
    into a port ``Field`` in its own dtype and device; the levels given
    count as saved history (``n_hist``), so a BDF2 ``Ddt`` reads both once
    ``varoo`` is loaded. Returns the field."""
    cur = field()
    var = _tensor(var, like=cur)
    if tuple(var.shape) != tuple(cur.shape):
        raise ValueError(f"field_from_numpy: shape {tuple(var.shape)} != {tuple(cur.shape)}")
    field.VAR = var
    if varo is not None:
        field.VARo = _tensor(varo, like=cur)
        field._n_hist = max(field.n_hist, 1)
    if varoo is not None:
        field._VARoo = _tensor(varoo, like=cur)
        field._n_hist = max(field.n_hist, 2)
    return field


def coeffs_from_numpy(coeffs, device, dtype) -> tuple:
    """Per-axis coefficient vectors ``((ap, ac, am), ...)`` as contiguous
    1-D tensors on ``device`` in ``dtype``."""
    return tuple(
        tuple(_tensor(c, device=device, dtype=dtype).contiguous() for c in cs)
        for cs in coeffs
    )


def gamma_from_numpy(g, like: torch.Tensor) -> torch.Tensor:
    """A diffusivity Γ of the JAX package (isotropic ``(*nx)`` or stacked
    ``(dim, *nx)``) or an advecting field (``(1 | dim, *nx)``), as numpy,
    as a contiguous tensor in ``like``'s dtype and device."""
    return _tensor(np.ascontiguousarray(g), like=like).contiguous()


def model_state_from_numpy(model, states, t: float = 0.0):
    """Load a transient model's state (``model.state_fields()``: the
    cavity's ``u, v[, w], p[, dp]``, the convection's ``T`` after them)
    from the JAX model's arrays as numpy, so both packages step on from
    the same mid-run state. ``states`` holds one entry per state field, in
    that order: the values, or ``(values, VARo[, VARoo])``. The model's
    clock is set to ``t``; each field takes its step and time from the
    model's clock at its next step. Returns the model."""
    fields = model.state_fields()
    if len(states) != len(fields):
        raise ValueError(f"model_state_from_numpy: {len(states)} states for {len(fields)} fields "
                         f"({[f.name for f in fields]})")
    for f, st in zip(fields, states):
        field_from_numpy(f, *(st if isinstance(st, (tuple, list)) else (st,)))
    model.t = t
    return model
