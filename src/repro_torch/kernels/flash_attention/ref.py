"""Plain PyTorch version of blocked causal/ragged attention.

It mirrors ``repro/kernels/flash_attention/ref.py`` (``mha_ref``) and
adds grouped-query attention: ``k`` and ``v`` may have fewer heads than
``q``, and query head ``h`` reads key/value head ``h // G`` with
``G = H / KV``.  With ``KV == H`` it is the reference's function.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lengths: torch.Tensor | None = None,
            causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, D), k/v: (B, KV, Sk, D), lengths: (B,) valid kv
    length.  Returns (B, H, Sq, D) float32.  Causal alignment is
    decode-style: query i attends to kv positions <= i + (Sk - Sq)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    q = q.float().reshape(b, kv, g, sq, d)
    k, v = k.float()[:, :, None], v.float()[:, :, None]
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    dev = q.device
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask = (torch.arange(sk, device=dev)[None, :]
                <= torch.arange(sq, device=dev)[:, None] + (sk - sq))
    mask = mask.expand(logits.shape)
    if lengths is not None:
        lmask = (torch.arange(sk, device=dev)
                 < lengths.to(dev)[:, None, None, None, None])
        mask = mask & lmask
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = torch.where(mask, w, 0.0)
    denom = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.matmul(w / denom, v).reshape(b, h, sq, d)
