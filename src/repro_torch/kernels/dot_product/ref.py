"""Plain PyTorch version of the DOT/SUM extension kernel (exact on any
device).

Unlike ``repro/kernels/dot_product/ref.py`` (``jnp.sum``, any order) the
order is fixed to the reference's ``det_sum`` (``semantics.py``): each
lane accumulates its rows in order, starting from the first active row's
product, then the lanes are reduced by the halving tree
``acc[:s] + acc[s:2s]``; every multiply and add follows the reference's
x86 rules (:mod:`repro_torch.kernels.fp32`).  With 16 lanes the result
is bit-identical to ``det_sum``.
"""
from __future__ import annotations

import torch

from .. import fp32

TILE_T = 8


def upcast_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 or bfloat16 -> float32 bit patterns (the upcast is exact)."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).to(torch.int32) << 16
    return fp32.as_bits(x)


def dot_product_ref(a: torch.Tensor, b: torch.Tensor, active: torch.Tensor,
                    tile: int = TILE_T) -> torch.Tensor:
    """``<a, b>`` over the active tiles, one sum per leading batch entry.

    ``a, b``: ``(T, L)`` or ``(B, T, L)``; ``active``: ``(ceil(T/tile),)``
    or ``(B, ceil(T/tile))``.  Returns a float32 scalar or ``(B,)``; a
    batch entry with no active tile sums to +0.
    """
    single = a.dim() == 2
    if single:
        a, b, active = a[None], b[None], active[None]
    ab, bb = upcast_bits(a), upcast_bits(b)
    B, T, L = ab.shape
    acc = torch.zeros((B, L), dtype=torch.int32, device=a.device)
    started = torch.zeros((B, 1), dtype=torch.bool, device=a.device)
    on = active != 0
    prod = fp32.mul(ab, bb)                 # every product is independent
    for r in range(T):
        act = on[:, r // tile, None]
        p = prod[:, r]
        acc = torch.where(act, torch.where(started, fp32.add(acc, p), p), acc)
        started = started | act
    s = L // 2
    while s >= 1:
        acc = fp32.add(acc[:, :s], acc[:, s:2 * s])
        s //= 2
    out = fp32.as_f32(acc[:, 0].contiguous())
    return out[0] if single else out
