"""internvl2: a stub ViT frontend and an InternLM2-style dense LM backbone.

The port of ``repro/models/vlm.py``.  The vision tower is a stub, as
there: the model takes precomputed patch embeddings (B, P, D_VIT) and
keeps the connector (a 2-layer MLP with the tanh GELU, ``jax.nn.gelu``'s
default) and the LM.  Prefill runs the transformer over the
[patches, tokens] sequence; decode is the transformer's decode over a
cache whose first P slots hold the image.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import transformer
from .common import ModelConfig, dense_init, rms_norm, softmax_cross_entropy

D_VIT = 1024   # InternViT-300M hidden size (the frontend stub's output)


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None, *,
                dtype=None) -> dict:
    """The transformer's leaves and the ``connector``; with ``dtype``,
    each drawn part cast to it at once."""
    p = transformer.init_params(gen, cfg, device, dtype=dtype)
    con = {"w1": dense_init(gen, (D_VIT, cfg.d_model), 0, cfg.param_dtype,
                            device),
           "w2": dense_init(gen, (cfg.d_model, cfg.d_model), 0,
                            cfg.param_dtype, device)}
    p["connector"] = con if dtype is None else transformer.cast(con, dtype)
    return p


def param_specs(cfg: ModelConfig) -> dict:
    s = transformer.param_specs(cfg)
    s["connector"] = {"w1": (None, "fsdp"), "w2": ("fsdp", None)}
    return s


def _project(cfg: ModelConfig, params, patch_embeds):
    """patch_embeds (B, P, D_VIT) -> (B, P, d) at ``cfg.dtype``."""
    c = params["connector"]
    h = patch_embeds.to(cfg.dtype) @ c["w1"].to(cfg.dtype)
    return F.gelu(h, approximate="tanh") @ c["w2"].to(cfg.dtype)


def embeds(cfg: ModelConfig, params, patch_embeds, tokens):
    """The LM's input: the projected patches, then the tokens' embeddings
    (B, P + S, d)."""
    txt = params["embed"].to(cfg.dtype)[tokens]
    return torch.cat([_project(cfg, params, patch_embeds), txt], dim=1)


def forward(cfg: ModelConfig, params, patch_embeds, tokens):
    """patch_embeds: (B, P, D_VIT); tokens: (B, S).  Returns the text
    positions' logits (B, S, V)."""
    x = embeds(cfg, params, patch_embeds, tokens)
    b, s = x.shape[:2]
    pos = torch.arange(s, device=x.device).expand(b, s)
    x = transformer.run_stack(cfg, params["blocks"], x, pos)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return transformer.unembed(cfg, params, x[:, patch_embeds.shape[1]:])


def loss_fn(cfg: ModelConfig, params, patch_embeds, tokens, mask=None):
    tokens = tokens.long()
    logits = forward(cfg, params, patch_embeds, tokens[:, :-1])
    m = mask[:, 1:] if mask is not None else None
    return softmax_cross_entropy(logits, tokens[:, 1:], m)


def prefill(cfg: ModelConfig, params, patch_embeds, tokens, max_len: int):
    """The transformer's prefill over [patches, tokens]."""
    return transformer.prefill(cfg, params, None,
                               embeds=embeds(cfg, params, patch_embeds,
                                             tokens), max_len=max_len)


# Decode is the transformer's, over a cache whose first P positions are
# the image's.
decode_step = transformer.decode_step
