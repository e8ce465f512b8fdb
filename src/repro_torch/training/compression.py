"""Gradient compression: per-tensor int8 quantisation with error
feedback (EF-SGD style).

The port of ``repro/training/compression.py``: the same codes and scales
(``torch.round`` rounds half to even, as ``jnp.round`` does), over named
leaves, with the gradients and the residual updated in place (a
full-width gradient tree and its residual leave no room for copies).
"""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor):
    """x (f32/bf16) -> (int8 codes, f32 scale)."""
    x32 = x.float()
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def init_residual(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


@torch.no_grad()
def apply_error_feedback(grads: dict, residual: dict):
    """Compress each gradient leaf; the quantisation error accumulates in
    ``residual`` and is re-injected next step.  Both dicts are updated in
    place and returned."""
    for k, g in grads.items():
        target = g.float() + residual[k]
        q, s = quantize(target)
        deq = dequantize(q, s)
        del q
        g.copy_(deq)
        residual[k].copy_(target - deq)
    return grads, residual
