"""State carried across from the JAX package.

This system has no learned weights: its state is field values (with
their history levels ``VARo``/``VARoo`` for Ddt), a flow's per-point
viscosity, per-axis coefficient
vectors, variable diffusivities Γ, advecting fields,
fast-diagonalization factors and the RFP potentials. These helpers turn
arrays of the JAX package (handed over as numpy) into the port's tensors,
so both packages can compute from the same state. The solver uses
``coeffs_from_numpy`` for its own host-built coefficient vectors too.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, like: torch.Tensor | None = None, device=None, dtype=None):
    """``a`` as a tensor on ``like``'s device in its dtype (or ``device`` /
    ``dtype``); on ``like``'s blocks when ``like`` is a block vector, each
    block's slice copied from the host straight to its device."""
    from pyapes_tpu_torch.parallel import blocks

    if like is not None:
        device, dtype = like.device, like.dtype
    a = np.asarray(a)
    if not a.flags.writeable:  # a JAX array's host view: own a copy
        a = a.copy()
    if isinstance(like, blocks.BlockTensor):
        return blocks.scatter(torch.as_tensor(a, dtype=dtype), like.placement)
    return torch.as_tensor(a, dtype=dtype, device=device)


def field_from_numpy(field, var, varo=None, varoo=None):
    """Load ``var`` (and optionally the history levels ``varo``/``varoo``)
    into a port ``Field`` in its own dtype and device (into its blocks,
    when its value is a block vector); the levels given
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


def model_state_from_numpy(model, states, t: float = 0.0, nu_field=None):
    """Load a transient model's state (``model.state_fields()``: the
    cavity's, the channel's or ``PeriodicFlow``'s ``u, v[, w], p[, dp]``,
    the convection's ``T`` after them) from the JAX model's arrays as
    numpy, so both packages step on from the same mid-run state. ``states``
    holds one entry per state field, in that order: the values, or
    ``(values, VARo[, VARoo])``. ``nu_field``: the JAX model's per-point
    viscosity (``_nu_field``), loaded as the model's viscosity field. The
    model's clock is set to ``t``; each field takes its step and time from
    the model's clock at its next step. Returns the model."""
    fields = model.state_fields()
    if len(states) != len(fields):
        raise ValueError(f"model_state_from_numpy: {len(states)} states for {len(fields)} fields "
                         f"({[f.name for f in fields]})")
    for f, st in zip(fields, states):
        field_from_numpy(f, *(st if isinstance(st, (tuple, list)) else (st,)))
    if nu_field is not None:
        model.update_viscosity(_tensor(nu_field, like=fields[0]()[0]))
    model.t = t
    return model


def rfp_state_from_numpy(model, pdf=None, H=None, G=None, jac_h=None, hess_g=None):
    """Load an RFP state of the JAX package, as numpy, into a port
    ``RFPEvolution`` so both packages step the same state: the potentials
    ``H`` and ``G`` (``(*nx)``; ``set_potentials`` derives them) and / or
    the derivatives as the JAX model holds them (``jac_h``: ``{"r", "z"}``,
    ``hess_g``: ``{"rr", "rz", "zz"}``), which replace the derived ones.
    ``pdf`` (``(*nx)`` or ``(1, *nx)``) comes back as a new ``Field`` on
    the model's mesh without BCs (the RFP operators impose their own
    zero-flux rows), else None. Returns ``(model, pdf_field)``."""
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.container import Hess, Jac

    mesh = model.mesh
    like = torch.zeros((), dtype=mesh.dtype.float, device=mesh.device)
    if H is not None and G is not None:
        model.set_potentials(_tensor(H, like=like), _tensor(G, like=like))
    if jac_h is not None:
        model.jacH = Jac(**{k: _tensor(v, like=like) for k, v in dict(jac_h).items()})
    if hess_g is not None:
        model.hessG = Hess(**{k: _tensor(v, like=like) for k, v in dict(hess_g).items()})
        model._hint = None
    f = None
    if pdf is not None:
        p = _tensor(pdf, like=like)
        f = Field("pdf", 1, mesh, None).set_var_tensor(p if p.ndim == mesh.dim + 1 else p[None])
    return model, f
