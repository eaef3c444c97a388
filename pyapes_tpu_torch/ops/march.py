"""Launch policy shared by the plane-march wrappers (``ops/jacobi.py``,
``ops/diff_field.py``, ``ops/axis_stencil.py``): the Python counterpart of
``csrc/march.cuh``.

A plane march launches one block per ``(j, k)`` column tile and chunk of
planes along axis 0 of one component. The chunk length adapts to the grid
and to the blocks the card holds at once (``march_geometry``,
``chunk_planes``, ``resident_blocks``): long chunks where the column tiles
alone fill the card, short ones where they do not. ``copy_bytes`` picks
the width of a staging copy (``cp.async``) from the row length and the
operands' alignment.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pyapes_tpu_torch.ops import cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


@functools.lru_cache(maxsize=256)
def chunk_planes(n0: int, columns: int, resident: int, setup: int) -> int:
    """Planes per block along axis 0 for ``columns`` column tiles (all
    components) when the card holds ``resident`` blocks at once: the chunk
    whose launch takes the fewest plane-steps, (waves of blocks) x (planes
    a block marches + ``setup``); the longest among equals."""
    best = None
    for nch in range(1, n0 + 1):
        ci = -(-n0 // nch)
        if -(-n0 // ci) != nch:
            continue
        cost = -(-columns * nch // resident) * (ci + setup)
        if best is None or cost < best[0]:
            best = (cost, ci)
    return best[1]


def march_geometry(shape, resident: int, chunk, tile, setup):
    """Launch geometry of a plane march on a ``(vdim, n0, n1, n2)`` grid
    in ``tile`` = ``(tj, tk)`` column tiles: ``(grid, chunk, partials)``.
    ``grid`` is ``(ceil(n2 / tk), ceil(n1 / tj), vdim * ceil(n0 /
    chunk))`` blocks; block ``(bx, by, bz)`` writes component ``bz //
    ceil(n0 / chunk)``, planes ``chunk * (bz % ceil(n0 / chunk))`` on (at
    most ``chunk`` of them), rows ``tj by`` on and columns ``tk bx`` on.
    ``chunk`` (planes per block): when None, ``chunk_planes``' choice for a
    card that holds ``resident`` blocks at once, each with a fixed cost of
    ``setup`` planes (its prologue); given, it is taken as is.
    ``partials``: the dot partials per component, one per block."""
    vdim, n0, n1, n2 = shape
    tj, tk = tile
    gx, gy = -(-n2 // tk), -(-n1 // tj)
    if chunk is None:
        chunk = chunk_planes(n0, gx * gy * vdim, resident, setup)
    chunk = max(1, min(int(chunk), n0))
    nch = -(-n0 // chunk)
    return (gx, gy, vdim * nch), chunk, gx * gy * nch


@functools.lru_cache(maxsize=None)
def resident_blocks(lib: ctypes.CDLL, device: int, entry: str, dtype: torch.dtype,
                    *flags: int) -> int:
    """Blocks of a plane march the card holds at once: its SMs times the
    blocks per SM that the kernel's registers and shared memory allow
    (from the C entry ``entry`` of ``lib`` with the kernel's template
    ``flags``)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(_DTYPE_CODE[dtype], *flags, ctypes.byref(blocks))
    cuda_build.check(lib, err, entry)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, blocks.value) * sms


def copy_bytes(b, n2, operands) -> int:
    """Bytes per staging copy of a plane march: the widest of 16, 8, 4 (at
    least an element) that divides a row and every operand's address; 0
    (element loads) when none does (bf16 rows of odd length)."""
    size = b.element_size()
    for cw in (16, 8, 4):
        if cw >= size and n2 * size % cw == 0 and all(t.data_ptr() % cw == 0 for t in operands):
            return cw
    return 0
