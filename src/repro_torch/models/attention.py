"""GQA attention: full-sequence (prefill) and decode (KV cache) paths.

The port of ``repro/models/attention.py``.  Where the reference computes
the scores as ``jnp`` einsums (and names the Pallas ``flash_attention``
kernel as their TPU implementation), both paths here run through the
hand-written :func:`repro_torch.kernels.flash_attention.ops.
flash_attention`: prefill as attention over its own ``S`` positions
(causal, or not for an encoder) or over another sequence (cross), decode
as one query row over the cache with ``lengths + 1`` live keys.  The projections stay plain products.

The KV cache is written in place (the reference returns a new array):
a decode step writes one row per request and layer, so copying the
whole cache each step would move it all for nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.flash_attention.ops import flash_attention
from .common import ModelConfig, dense_init, rotary


def attn_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    pd = cfg.param_dtype
    return {
        "wq": dense_init(gen, (d, h, hd), 0, pd, device),
        "wk": dense_init(gen, (d, kv, hd), 0, pd, device),
        "wv": dense_init(gen, (d, kv, hd), 0, pd, device),
        "wo": dense_init(gen, (h, hd, d), (0, 1), pd, device),
    }


def _project(x, w):
    """``x @ w`` for x (..., d) and w (d, heads, hd) -> (..., heads, hd)."""
    d, heads, hd = w.shape
    return (x @ w.reshape(d, heads * hd)).unflatten(-1, (heads, hd))


def _out(o, wo):
    """o (..., H, hd) times wo (H, hd, d) -> (..., d)."""
    h, hd, d = wo.shape
    return o.flatten(-2) @ wo.reshape(h * hd, d)


def attend(cfg: ModelConfig, p, x, positions, *, causal=True, kv_x=None,
           kv_lengths=None, return_kv=False):
    """Full-sequence attention.  x: (B, S, d); positions: (B, S), the
    query positions 0..S-1 (rotary).  ``kv_x`` (B, T, d): cross-attention
    over it (no rotary, never causal).  ``kv_lengths`` (B,) int32: each
    row attends to keys ``< kv_lengths`` only, the reference's ragged
    mask ``kv_valid = arange(T) < kv_lengths`` (the only mask its callers
    build); a row with no live key gives 0, as the reference's.
    ``return_kv``: also return (k, v) as (B, KV, T, hd) for a cache."""
    b, s, _ = x.shape
    src = x if kv_x is None else kv_x
    q = _project(x, p["wq"].to(x.dtype))
    k = _project(src, p["wk"].to(x.dtype))
    v = _project(src, p["wv"].to(x.dtype))
    if kv_x is None:                 # rotary only for self-attention
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, positions, cfg.rope_theta)
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if kv_lengths is None:
        kv_lengths = torch.full((b,), src.shape[1], dtype=torch.int32,
                                device=x.device)
    o = flash_attention(q, k, v, kv_lengths.to(torch.int32),
                        causal=causal and kv_x is None)   # (B, H, S, hd)
    out = _out(o.transpose(1, 2), p["wo"].to(x.dtype))
    if return_kv:
        return out, (k, v)
    return out


# --------------------------------------------------------------------------
# Decode path
# --------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor        # (L, B, KV, S_max, hd)
    v: torch.Tensor        # (L, B, KV, S_max, hd)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
               dtype=None, device=None) -> KVCache:
    shape = (n_layers, batch, cfg.kv_heads, max_len, cfg.hd)
    dtype = dtype or cfg.dtype
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _write_at(cache, new, lengths):
    """cache: (B, KV, S, hd), written in place; new: (B, KV, hd); lengths:
    (B,) write positions, clamped into the cache as
    ``lax.dynamic_update_slice`` clamps them."""
    pos = lengths.long().clamp(0, cache.shape[2] - 1)
    cache[torch.arange(cache.shape[0], device=cache.device), :, pos] = new
    return cache


def attend_decode(cfg: ModelConfig, p, x, layer_cache: KVCache, lengths,
                  *, rope=True):
    """One-token decode.  x: (B, d); lengths: (B,) current lengths (the new
    token is written at ``lengths`` and attends to ``<= lengths``).

    Returns (out (B, d), layer_cache), the cache updated in place.
    """
    q = _project(x, p["wq"].to(x.dtype))                   # (B, H, hd)
    kn = _project(x, p["wk"].to(x.dtype))
    vn = _project(x, p["wv"].to(x.dtype))
    if rope:
        q = rotary(q[:, None], lengths[:, None], cfg.rope_theta)[:, 0]
        kn = rotary(kn[:, None], lengths[:, None], cfg.rope_theta)[:, 0]
    ck = _write_at(layer_cache.k, kn.to(layer_cache.k.dtype), lengths)
    cv = _write_at(layer_cache.v, vn.to(layer_cache.v.dtype), lengths)
    o = flash_attention(q[:, :, None].contiguous(), ck, cv,
                        (lengths + 1).to(torch.int32), causal=False)
    out = _out(o[:, :, 0], p["wo"].to(x.dtype))
    return out, KVCache(k=ck, v=cv)
