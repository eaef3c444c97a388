"""Jacobian / Hessian derivative containers (PyTorch port of
``pyapes_tpu/variables/container.py``): string-keyed first and second
derivatives of a scalar field, one ``(*nx)`` tensor per key.

``zz`` is declared once (the original torch reference declared it twice).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


class Derivatives:
    """Base for ``Jac``/``Hess``: generic string indices (``x``, ``xz``,
    ...), keys looked up alphabetically sorted (``hess["zx"]`` is
    ``hess.xz``), iteration over the populated entries only."""

    _FIELDS: tuple[str, ...] = ()

    def __init__(self):
        self.keys = [k for k in self._FIELDS if getattr(self, k) is not None]
        self.max = len(self.keys)

    def __getitem__(self, key: str) -> torch.Tensor:
        item = getattr(self, "".join(sorted(key.lower())))
        if item is None:
            raise KeyError(f"Derivative: key {key} not found.")
        return item

    def __len__(self) -> int:
        return self.max

    def __iter__(self):
        self._n = 0
        return self

    def __next__(self):
        if self._n < self.max:
            res = getattr(self, self.keys[self._n])
            self._n += 1
            return res
        raise StopIteration


@dataclass
class Jac(Derivatives):
    """First derivatives, keys ``x/y/z`` (Cartesian) or ``r/z`` (rz)."""

    x: torch.Tensor | None = None
    y: torch.Tensor | None = None
    z: torch.Tensor | None = None
    r: torch.Tensor | None = None

    _FIELDS = ("x", "y", "z", "r")

    def __post_init__(self):
        super().__init__()


@dataclass
class Hess(Derivatives):
    """Second derivatives, upper-triangular keys (``hess["zx"] -> hess.xz``)."""

    xx: torch.Tensor | None = None
    xy: torch.Tensor | None = None
    xz: torch.Tensor | None = None
    yy: torch.Tensor | None = None
    yz: torch.Tensor | None = None
    zz: torch.Tensor | None = None
    rr: torch.Tensor | None = None
    rz: torch.Tensor | None = None

    _FIELDS = ("xx", "xy", "xz", "yy", "yz", "zz", "rr", "rz")

    def __post_init__(self):
        super().__init__()
