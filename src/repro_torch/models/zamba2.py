"""zamba2 hybrid: a Mamba2 backbone with one *shared* transformer block
applied every ``shared_attn_period`` layers (one set of attention
weights reused at several depths).

The port of ``repro/models/zamba2.py``: groups of ``shared_attn_period``
Mamba2 layers, each group followed by the shared GQA block (38 layers at
period 6: groups of 6, 6, 6, 6, 6, 6 and 2, so 7 sites, each with its
own KV cache).  Like the reference, the single-shared-block variant
without the embedding concatenation into the shared block.  The shared
block's attention runs through the hand-written ``flash_attention``;
the Mamba2 layers are plain PyTorch (:mod:`.mamba2`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import attention, mamba2, transformer
from .common import ModelConfig, embed_init, rms_norm, softmax_cross_entropy


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None, *,
                dtype=None) -> dict:
    """The reference's leaves (``mamba`` one dict a layer); with
    ``dtype``, each drawn part cast to it at once."""
    keep = (lambda t: t) if dtype is None \
        else (lambda t: transformer.cast(t, dtype))
    pd = cfg.param_dtype
    return {
        "embed": keep(embed_init(gen, (cfg.vocab, cfg.d_model), pd, device)),
        "mamba": [keep(mamba2.ssd_params(gen, cfg, device))
                  for _ in range(cfg.n_layers)],
        "shared_attn": keep(transformer.block_params(gen, cfg, device)),
        "ln_f": keep(torch.ones(cfg.d_model, dtype=pd, device=device)),
        "unembed": keep(embed_init(gen, (cfg.d_model, cfg.vocab), pd,
                                   device)),
    }


def param_specs(cfg: ModelConfig) -> dict:
    return {"embed": ("vocab", "fsdp"),
            "mamba": [mamba2.ssd_specs() for _ in range(cfg.n_layers)],
            "shared_attn": transformer.block_specs(cfg),
            "ln_f": (None,),
            "unembed": ("fsdp", "vocab")}


def _groups(cfg: ModelConfig):
    period = cfg.shared_attn_period
    bounds = list(range(0, cfg.n_layers, period)) + [cfg.n_layers]
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def _mamba_block(cfg: ModelConfig, lp, x):
    return x + mamba2.ssd_apply(cfg, lp, rms_norm(x, lp["ln"], cfg.norm_eps))


def forward(cfg: ModelConfig, params, tokens):
    """tokens: (B, S).  Returns logits (B, S, V)."""
    x = params["embed"].to(cfg.dtype)[tokens]
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    for lo, hi in _groups(cfg):
        for lp in params["mamba"][lo:hi]:
            if remat:
                x = checkpoint(_mamba_block, cfg, lp, x, use_reentrant=False)
            else:
                x = _mamba_block(cfg, lp, x)
        x = transformer.block_apply(cfg, params["shared_attn"], x, positions)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return transformer.unembed(cfg, params, x)


def loss_fn(cfg: ModelConfig, params, tokens, mask=None):
    tokens = tokens.long()
    logits = forward(cfg, params, tokens[:, :-1])
    m = mask[:, 1:] if mask is not None else None
    return softmax_cross_entropy(logits, tokens[:, 1:], m)


# --------------------------------------------------------------------------
# Decode: Mamba2 recurrent states + one KV cache per shared-block site
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               dtype=None) -> dict:
    return {"ssm": mamba2.init_ssd_state(cfg, batch, cfg.n_layers, device),
            "kv": attention.init_cache(cfg, batch, max_len, len(_groups(cfg)),
                                       dtype=dtype, device=device)}


def cache_specs(cfg: ModelConfig) -> dict:
    cs = attention.cache_specs(cfg)
    return {"ssm": mamba2.ssd_state_spec(), "kv": attention.KVCache(cs, cs)}


def prefill(cfg: ModelConfig, params, tokens, max_len: int):
    """The chunked-SSD forward, collecting each layer's final SSM state
    and each site's shared-attention K/V (padded to ``max_len``).

    Returns (last-token logits (B, V), cache, lengths (B,))."""
    x = params["embed"].to(cfg.dtype)[tokens]
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = init_cache(cfg, b, max_len, x.device, x.dtype)
    for site, (lo, hi) in enumerate(_groups(cfg)):
        for li in range(lo, hi):
            lp = params["mamba"][li]
            y, cache["ssm"][li] = mamba2.ssd_apply(
                cfg, lp, rms_norm(x, lp["ln"], cfg.norm_eps),
                return_state=True)
            x = x + y
        x, (k, v) = transformer.block_apply(cfg, params["shared_attn"], x,
                                            positions, return_kv=True)
        cache["kv"].k[site, :, :, :s] = k
        cache["kv"].v[site, :, :, :s] = v
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return transformer.unembed(cfg, params, x[:, -1]), cache, \
        torch.full((b,), s, dtype=torch.int32, device=x.device)


def decode_step(cfg: ModelConfig, params, cache, token, lengths):
    """One decode step.  token: (B,); lengths: (B,).  The cache is
    updated in place.  Returns (logits (B, V), cache, lengths + 1)."""
    x = params["embed"].to(cfg.dtype)[token]
    kv = cache["kv"]
    for site, (lo, hi) in enumerate(_groups(cfg)):
        for li in range(lo, hi):
            lp = params["mamba"][li]
            y, cache["ssm"][li] = mamba2.ssd_decode(
                cfg, lp, rms_norm(x, lp["ln"], cfg.norm_eps),
                cache["ssm"][li])
            x = x + y
        x, _ = transformer.block_decode(
            cfg, params["shared_attn"], x,
            attention.KVCache(kv.k[site], kv.v[site]), lengths)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return transformer.unembed(cfg, params, x), cache, lengths + 1
