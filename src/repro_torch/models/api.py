"""Model API for the families the port trains and serves: ``dense`` and
``moe``.

The port of ``repro/models/api.py``.  The other families
(``mamba_hybrid``, ``xlstm``, ``encdec``, ``vlm``) are not ported yet
and raise ``NotImplementedError`` (see ROADMAP.md, queue 1, item 11);
the mesh ``param_specs`` / ``cache_specs`` wait for ``sharding/``.
"""
from __future__ import annotations

import torch

from . import attention, transformer
from .common import ModelConfig

FAMILIES = ("dense", "moe")


def _check(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            "repro_torch yet; see ROADMAP.md queue 1, item 11")


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None, *,
                keep_master: bool = True) -> transformer.Transformer:
    """``keep_master=False``: parameters at ``cfg.dtype`` only, for a
    model that serves and never trains (see :class:`Transformer`)."""
    _check(cfg)
    return transformer.Transformer.init(cfg, gen, device,
                                        keep_master=keep_master)


def loss(cfg: ModelConfig, model: transformer.Transformer, batch):
    """batch: ``{"tokens": (B, S)[, "mask": (B, S)]}``.  The scalar
    next-token loss over the model's master parameters (differentiable
    where they require a gradient)."""
    _check(cfg)
    return transformer.loss_fn(cfg, model.params(), batch["tokens"],
                               mask=batch.get("mask"))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> attention.KVCache:
    _check(cfg)
    return attention.init_cache(cfg, batch, max_len, cfg.n_layers,
                                device=device)


def prefill(cfg: ModelConfig, model: transformer.Transformer, batch,
            max_len: int):
    """batch: ``{"tokens": (B, S)}``.  Returns (logits (B, V), cache,
    lengths)."""
    _check(cfg)
    return model.prefill(batch["tokens"], max_len=max_len)


def decode(cfg: ModelConfig, model: transformer.Transformer, cache, token,
           lengths):
    _check(cfg)
    return model.decode_step(cache, token, lengths)
