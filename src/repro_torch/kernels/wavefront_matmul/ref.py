"""Plain PyTorch version of the dynamically masked block matmul.

It mirrors ``repro/kernels/wavefront_matmul/ref.py`` (``C = A @ B`` in
float32 with whole row tiles of A and C disabled), with a leading batch
axis (one matrix per MoE expert), ragged ``M``, ``N`` and ``K``, and the
kernel's output type (``a.dtype``).
"""
from __future__ import annotations

import torch

TILE_M = 128


def tile_mask(row_active: torch.Tensor, rows: int,
              tile: int = TILE_M) -> torch.Tensor:
    """Per-row flag ``(..., rows)`` from the per-tile bitmap
    ``(..., ceil(rows / tile))``."""
    return torch.repeat_interleave(row_active != 0, tile, dim=-1)[..., :rows]


def wavefront_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                         row_active: torch.Tensor,
                         tile_m: int = TILE_M) -> torch.Tensor:
    """``C = A @ B`` with inactive row tiles of ``C`` zero.

    a: ``([E,] M, K)``, b: ``([E,] K, N)``, row_active:
    ``([E,] ceil(M / tile_m))``.  The product is taken in float32 and
    returned in ``a.dtype``.
    """
    c = torch.matmul(a.float(), b.float())
    keep = tile_mask(row_active, a.shape[-2], tile_m)[..., None]
    return torch.where(keep, c, 0.0).to(a.dtype)
