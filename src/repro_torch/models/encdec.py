"""Encoder-decoder backbone (seamless-m4t): a bidirectional encoder over
stub audio-frame embeddings and a causal decoder with cross-attention.

The port of ``repro/models/encdec.py``.  The frontend is a stub, as
there: the encoder takes precomputed frame embeddings (B, S_enc, d).
Ragged frame counts are per-row lengths (``enc_lengths`` (B,) int32,
the reference's ``enc_valid = arange(S_enc) < enc_lengths``).  Every
attention, the encoder's non-causal self-attention, the decoder's
causal self-attention and its cross-attention, in prefill and decode,
runs through the hand-written ``flash_attention``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention.ops import flash_attention
from . import attention, transformer
from .common import (ModelConfig, dense_init, embed, embed_init,
                     full_like_batch, gather_fsdp, rms_norm,
                     softmax_cross_entropy)


def _ones(cfg, device):
    return torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=device)


def _dec_block_params(gen, cfg: ModelConfig, device=None) -> dict:
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {"self_attn": attention.attn_params(gen, cfg, device),
            "cross_attn": attention.attn_params(gen, cfg, device),
            "ln_self": _ones(cfg, device), "ln_cross": _ones(cfg, device),
            "ln_mlp": _ones(cfg, device),
            "mlp": {"w_in": dense_init(gen, (d, f), 0, pd, device),
                    "w_gate": dense_init(gen, (d, f), 0, pd, device),
                    "w_out": dense_init(gen, (f, d), 0, pd, device)}}


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None, *,
                dtype=None) -> dict:
    """The reference's leaves (``enc`` and ``dec`` one dict a layer, an
    encoder layer a dense transformer block); with ``dtype``, each drawn
    part cast to it at once."""
    keep = (lambda t: t) if dtype is None \
        else (lambda t: transformer.cast(t, dtype))
    pd = cfg.param_dtype
    return {
        "embed": keep(embed_init(gen, (cfg.vocab, cfg.d_model), pd, device)),
        "enc": [keep(transformer.block_params(gen, cfg, device))
                for _ in range(cfg.enc_layers)],
        "dec": [keep(_dec_block_params(gen, cfg, device))
                for _ in range(cfg.dec_layers)],
        "ln_enc": keep(_ones(cfg, device)),
        "ln_dec": keep(_ones(cfg, device)),
        "unembed": keep(embed_init(gen, (cfg.d_model, cfg.vocab), pd,
                                   device)),
    }


def param_specs(cfg: ModelConfig) -> dict:
    enc = transformer.block_specs(cfg)
    dec = {"self_attn": attention.attn_specs(),
           "cross_attn": attention.attn_specs(), "ln_self": (None,),
           "ln_cross": (None,), "ln_mlp": (None,),
           "mlp": transformer.MLP_SPECS}
    return {"embed": ("vocab", "fsdp"),
            "enc": [enc for _ in range(cfg.enc_layers)],
            "dec": [dec for _ in range(cfg.dec_layers)],
            "ln_enc": (None,), "ln_dec": (None,),
            "unembed": ("fsdp", "vocab")}


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def _run(cfg: ModelConfig, body, layers, x):
    """``body(lp, x)`` over the layers, each under a checkpoint with
    ``cfg.remat`` when a gradient is wanted."""
    remat = cfg.remat and torch.is_grad_enabled()
    run = lambda lp, x: body(gather_fsdp(lp), x)
    for lp in layers:
        x = checkpoint(run, lp, x, use_reentrant=False) if remat \
            else run(lp, x)
    return x


def encode(cfg: ModelConfig, params, frame_embeds, enc_lengths=None):
    """frame_embeds: (B, S_enc, d) -> the encoder's output (B, S_enc, d)
    at ``cfg.dtype``."""
    x = frame_embeds.to(cfg.dtype)
    pos = _positions(x)

    def body(lp, x):
        return transformer.block_apply(cfg, lp, x, pos, causal=False,
                                       kv_lengths=enc_lengths)

    x = _run(cfg, body, params["enc"], x)
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


def decode_train(cfg: ModelConfig, params, tokens, enc_out,
                 enc_lengths=None):
    """The decoder over whole sequences.  tokens: (B, S).  Returns logits
    (B, S, V)."""
    x = embed(cfg, params, tokens)
    pos = _positions(x)

    def body(lp, x):
        h = rms_norm(x, lp["ln_self"], cfg.norm_eps)
        x = x + attention.attend(cfg, lp["self_attn"], h, pos, causal=True)
        h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        x = x + attention.attend(cfg, lp["cross_attn"], h, pos, causal=False,
                                 kv_x=enc_out, kv_lengths=enc_lengths)
        return x + transformer._ffn(cfg, lp,
                                    rms_norm(x, lp["ln_mlp"], cfg.norm_eps))

    x = _run(cfg, body, params["dec"], x)
    x = rms_norm(x, params["ln_dec"], cfg.norm_eps)
    return transformer.unembed(cfg, params, x)


def loss_fn(cfg: ModelConfig, params, frame_embeds, tokens, mask=None,
            enc_lengths=None):
    tokens = tokens.long()
    enc_out = encode(cfg, params, frame_embeds, enc_lengths)
    logits = decode_train(cfg, params, tokens[:, :-1], enc_out, enc_lengths)
    m = mask[:, 1:] if mask is not None else None
    return softmax_cross_entropy(logits, tokens[:, 1:], m)


# --------------------------------------------------------------------------
# Serving: a self-attention KV cache and the precomputed cross K/V
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               device=None, dtype=None, like=None) -> dict:
    """Zeros; with ``like`` (the batch's activations), placed by its batch
    (``common.full_like_batch``)."""
    dtype = dtype or cfg.dtype
    cross = (cfg.dec_layers, batch, cfg.kv_heads, enc_len, cfg.hd)
    if like is not None:
        zeros = lambda shape, dt, dim: full_like_batch(like, shape, 0, dt,
                                                       dim)
    else:
        zeros = lambda shape, dt, dim: torch.zeros(shape, dtype=dt,
                                                   device=device)
    return {
        "self": attention.init_cache(cfg, batch, max_len, cfg.dec_layers,
                                     dtype=dtype, device=device, like=like),
        "cross_k": zeros(cross, dtype, 1),
        "cross_v": zeros(cross, dtype, 1),
        "enc_len": zeros((batch,), torch.int32, 0),
    }


def cache_specs(cfg: ModelConfig) -> dict:
    cs = attention.cache_specs(cfg)
    return {"self": attention.KVCache(cs, cs), "cross_k": cs, "cross_v": cs,
            "enc_len": ("batch",)}


def prefill_cross(cfg: ModelConfig, params, enc_out, enc_lengths):
    """Each decoder layer's cross K/V from the encoder's output, stacked
    as (L, B, KV, T, hd), contiguous (so that a layer's slice is too, as
    the kernel's TMA routes need)."""
    def kv(w):
        return attention._project(enc_out,
                                  w.to(enc_out.dtype)).transpose(1, 2)
    ks = torch.stack([kv(gather_fsdp(lp["cross_attn"]["wk"]))
                      for lp in params["dec"]])
    vs = torch.stack([kv(gather_fsdp(lp["cross_attn"]["wv"]))
                      for lp in params["dec"]])
    return ks.contiguous(), vs.contiguous(), enc_lengths


def _cross_decode(cfg: ModelConfig, p, x, ck, cv, enc_len):
    """x: (B, d); ck, cv: (B, KV, T, hd); enc_len: (B,) live keys."""
    q = attention._project(x, p["wq"].to(x.dtype))               # (B, H, hd)
    o = flash_attention(q[:, :, None].contiguous(), ck, cv,
                        enc_len.to(torch.int32), causal=False)
    return attention._out(o[:, :, 0], p["wo"].to(x.dtype))


def decode_step(cfg: ModelConfig, params, cache, token, lengths):
    """One decode step.  The self-attention cache is updated in place.
    Returns (logits (B, V), cache, lengths + 1)."""
    x = embed(cfg, params, token)
    sc = cache["self"]
    for i, lp in enumerate(params["dec"]):
        lp = gather_fsdp(lp)
        h = rms_norm(x, lp["ln_self"], cfg.norm_eps)
        a, _ = attention.attend_decode(cfg, lp["self_attn"], h,
                                       attention.KVCache(sc.k[i], sc.v[i]),
                                       lengths)
        x = x + a
        h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        x = x + _cross_decode(cfg, lp["cross_attn"], h, cache["cross_k"][i],
                              cache["cross_v"][i], cache["enc_len"])
        x = x + transformer._ffn(cfg, lp,
                                 rms_norm(x, lp["ln_mlp"], cfg.norm_eps))
    x = rms_norm(x, params["ln_dec"], cfg.norm_eps)
    return transformer.unembed(cfg, params, x), cache, lengths + 1
