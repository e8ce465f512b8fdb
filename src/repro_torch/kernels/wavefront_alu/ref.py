"""Plain PyTorch version of the wavefront ALU kernel (exact on any device).

It mirrors ``repro/kernels/wavefront_alu/ref.py`` but works on the
float32 *bit patterns*, with the reference's x86 rules made explicit
(:mod:`repro_torch.kernels.fp32`), and it masks a ragged last tile
instead of requiring ``T % 8 == 0``.
"""
from __future__ import annotations

import torch

from .. import fp32

OPS = ("add", "sub", "mul", "max", "min")
TILE_T = 8


def tile_mask(active: torch.Tensor, rows: int, tile: int = TILE_T):
    """Per-row flag from the per-tile activity bitmap ``(ceil(rows/tile),)``."""
    return torch.repeat_interleave(active != 0, tile)[:rows]


def wavefront_alu_ref(a: torch.Tensor, b: torch.Tensor, init: torch.Tensor,
                      active: torch.Tensor, op: str,
                      tile: int = TILE_T) -> torch.Tensor:
    """``op`` over the rows of active tiles; inactive tiles keep ``init``
    bit for bit.  ``a, b, init``: ``(T, L)`` float32; ``active``:
    ``(ceil(T / tile),)`` int32 or bool."""
    f = fp32.BINARY[op]
    out = f(fp32.as_bits(a), fp32.as_bits(b))
    keep = tile_mask(active, a.shape[0], tile)[:, None]
    return fp32.as_f32(torch.where(keep, out, fp32.as_bits(init)))
