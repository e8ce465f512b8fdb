"""Plain PyTorch version of the dynamically masked block matmul.

It mirrors ``repro/kernels/wavefront_matmul/ref.py`` (``C = A @ B`` in
float32 with whole row tiles of A and C disabled), with a leading batch
axis (one matrix per MoE expert), ragged ``M``, ``N`` and ``K``, and the
kernel's output type (``a.dtype``).  :func:`wavefront_matmul_ref_bwd`
is its gradient, two products with the same masking (the reference has
no backward kernel: XLA differentiates its expert einsums).
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
    c = torch.matmul(_acc(a), _acc(b))
    keep = tile_mask(row_active, a.shape[-2], tile_m)[..., None]
    return torch.where(keep, c, 0.0).to(a.dtype)


def _acc(x: torch.Tensor) -> torch.Tensor:
    """float32, or float64 for float64 inputs."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def wavefront_matmul_ref_bwd(a: torch.Tensor, b: torch.Tensor,
                             row_active: torch.Tensor, dc: torch.Tensor,
                             tile_m: int = TILE_M):
    """The gradient of :func:`wavefront_matmul_ref` at ``dc``:
    ``(dA, dB)`` in ``a``'s and ``b``'s types.  An inactive tile's output
    was zero whatever ``A`` held, so its rows of ``dC`` count for
    nothing: ``dA = mask(dC) B^T`` (inactive rows zero) and
    ``dB = A^T mask(dC)``."""
    keep = tile_mask(row_active, a.shape[-2], tile_m)[..., None]
    dcm = torch.where(keep, _acc(dc), 0.0)
    da = torch.matmul(dcm, _acc(b).transpose(-1, -2))
    db = torch.matmul(_acc(a).transpose(-1, -2), dcm)
    return da.to(a.dtype), db.to(b.dtype)
