"""Backend configuration: dtype policy and device resolution.

PyTorch counterpart of ``pyapes_tpu/backend.py``. The dtype is an explicit
policy object plumbed through ``Mesh`` (no global default-tensor-type
mutation), and the device is an explicit ``torch.device`` carried by the
mesh. Unlike the JAX package, asking for CUDA where no CUDA device exists
RAISES instead of silently falling back to another device: a solve that
was meant for the GPU must never quietly run on the CPU.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

DEVICE_TYPES = ["cpu", "cuda", "gpu"]
"""Accepted device aliases; ``gpu`` is an alias of ``cuda``."""

DTYPE_SINGLE = ["single", "s", 32]
DTYPE_DOUBLE = ["double", "d", 64]
DTYPE_HALF = ["half", "bf16", 16]


def set_full_precision_matmul() -> None:
    """Pin float32 matrix products to true float32 (TF32 off).

    The fast-diagonalization solve reaches ~1e-6 relative residual in one
    pass only with full-mantissa transforms (``solver/fastdiag.py``); a
    TF32 pass keeps ~3 decimal digits and costs about four orders of
    one-pass accuracy. PyTorch's matmul default is already full float32,
    but cuDNN's is TF32, and both are process-global switches another
    library may flip — so the port sets all three explicitly whenever a
    device is resolved."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def transform_matmul(tf32: bool = False, bf16_f32_accumulate: bool = False):
    """Within: float32 matrix products may run in TF32 (``tf32``) and bf16
    ones accumulate in float32 with no reduced-precision split-K reduction
    (``bf16_f32_accumulate``); on exit, an exception included, every flag
    this sets is back as it was (``set_full_precision_matmul``'s pins
    among them). For the fast-diagonalization transforms of ``fd_opts``
    (``solver/fastdiag.py``). cuBLAS takes the math mode at each call (at
    capture time inside a CUDA graph, which replays it); on the CPU the
    flags change nothing."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision(),
             m.allow_bf16_reduced_precision_reduction)
    try:
        if tf32:
            m.allow_tf32 = True
        if bf16_f32_accumulate:
            m.allow_bf16_reduced_precision_reduction = False
        yield
    finally:
        m.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
        m.allow_bf16_reduced_precision_reduction = saved[3]


def local_device_count() -> int:
    """CUDA devices this process sees (the JAX package's local devices)."""
    return torch.cuda.device_count()


def default_backend() -> str:
    """``"gpu"`` where CUDA is available, else ``"cpu"``."""
    return "gpu" if torch.cuda.is_available() else "cpu"


def np_dtype(dtype) -> np.dtype:
    """numpy dtype of host-side data for a torch (or numpy) dtype. numpy
    has no bfloat16: host vectors of bf16 meshes stay float32 and round
    when they are copied to the device."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return np.dtype(np.float32)
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


@dataclass
class DType:
    """Data-type policy for a simulation (reference ``backend.py:13-67``).

    Examples:
        >>> DType("single").float
        torch.float32
        >>> DType("double").float
        torch.float64
    """

    precision: str | int = "double"

    def __post_init__(self):
        if self.precision in DTYPE_SINGLE:
            self._float = torch.float32
            self._complex = torch.complex64
            self._int = torch.int32
        elif self.precision in DTYPE_DOUBLE:
            self._float = torch.float64
            self._complex = torch.complex128
            self._int = torch.int64
        elif self.precision in DTYPE_HALF:
            self._float = torch.bfloat16
            self._complex = torch.complex64
            self._int = torch.int32
        else:
            raise ValueError("Invalid precision type!")
        self._bool = torch.bool

    @property
    def float(self) -> torch.dtype:
        return self._float

    @property
    def int(self) -> torch.dtype:
        return self._int

    @property
    def complex(self) -> torch.dtype:
        return self._complex

    @property
    def bool(self) -> torch.dtype:
        return self._bool

    def __repr__(self) -> str:
        return f"(torch.dtype){self.precision}"


@dataclass
class Device:
    """Compute device handle (reference ``TorchDevice``, ``backend.py:70-94``).

    Resolves ``"cpu"`` / ``"cuda"`` / ``"gpu"`` (optionally with an index,
    ``"cuda:1"``) to a ``torch.device``; the default is the card. Raises
    ``RuntimeError`` when CUDA is requested but unavailable: the CPU is
    used only when the caller asks for it.
    """

    device_type: str = "cuda"

    def __post_init__(self):
        alias = str(self.device_type).lower()
        kind, _, index = alias.partition(":")
        if kind not in DEVICE_TYPES:
            raise ValueError(f"Device: unknown device {alias!r}")
        if kind == "cpu":
            self._device = torch.device("cpu")
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"Device: {alias!r} requested but torch.cuda.is_available()"
                    " is False (no CUDA device or a CPU-only torch build)"
                )
            self._device = torch.device("cuda", int(index) if index else 0)
        set_full_precision_matmul()

    @property
    def device(self) -> torch.device:
        return self._device

    def __repr__(self) -> str:
        return f"Device on {self._device}"
