"""One model API over the six families: ``dense``, ``moe``,
``mamba_hybrid`` (zamba2), ``xlstm``, ``encdec`` (seamless-m4t) and
``vlm`` (internvl2).

The port of ``repro/models/api.py``.  A model is a
:class:`~.transformer.Model` (its parameter tree, the reference's
layout with one dict per layer, and its serving copy); ``prefill`` and
``decode`` run on the serving copy under ``no_grad``, ``loss`` on the
parameters themselves.  Batches are the reference's: ``{"tokens"}``,
plus ``"frames"`` (B, S_enc, d) for ``encdec`` and ``"patches"`` (B, P,
D_VIT) for ``vlm``.  ``param_specs`` and ``cache_specs`` give each
leaf's logical sharding spec (resolved by ``repro_torch.sharding``) in
the port's own layout: a part the reference stacks on a leading
``"layers"`` axis is a list of per-layer specs without that entry.
"""
from __future__ import annotations

import torch

from . import attention, encdec, transformer, vlm, xlstm, zamba2
from .common import ModelConfig

FAMILIES = ("dense", "moe", "mamba_hybrid", "xlstm", "encdec", "vlm")

#: family -> the module whose ``init_params`` draws its tree
_INIT = {"mamba_hybrid": zamba2, "xlstm": xlstm, "encdec": encdec,
         "vlm": vlm}


def _check(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) has no model in "
            f"repro_torch; the families are {FAMILIES}")


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None, *,
                keep_master: bool = True) -> transformer.Model:
    """``keep_master=False``: parameters at ``cfg.dtype`` only, for a
    model that serves and never trains (see :class:`~.transformer.
    Model`)."""
    _check(cfg)
    if cfg.family not in _INIT:
        return transformer.Transformer.init(cfg, gen, device,
                                            keep_master=keep_master)
    tree = _INIT[cfg.family].init_params(
        gen, cfg, device, dtype=None if keep_master else cfg.dtype)
    return transformer.Model(cfg, tree)


def param_specs(cfg: ModelConfig) -> dict:
    """Logical specs with the structure of the model's :meth:`~.transformer.
    Model.params`."""
    _check(cfg)
    if cfg.family in _INIT:
        return _INIT[cfg.family].param_specs(cfg)
    return transformer.param_specs(cfg)


def loss(cfg: ModelConfig, model: transformer.Model, batch):
    """The scalar next-token loss over the model's master parameters
    (differentiable where they require a gradient); ``batch["mask"]``,
    where given, weights the positions."""
    _check(cfg)
    params, mask = model.params(), batch.get("mask")
    if cfg.family == "mamba_hybrid":
        return zamba2.loss_fn(cfg, params, batch["tokens"], mask)
    if cfg.family == "xlstm":
        return xlstm.loss_fn(cfg, params, batch["tokens"], mask)
    if cfg.family == "encdec":
        return encdec.loss_fn(cfg, params, batch["frames"], batch["tokens"],
                              mask)
    if cfg.family == "vlm":
        return vlm.loss_fn(cfg, params, batch["patches"], batch["tokens"],
                           mask)
    return transformer.loss_fn(cfg, params, batch["tokens"], mask=mask)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               enc_len: int = 4096):
    _check(cfg)
    if cfg.family == "mamba_hybrid":
        return zamba2.init_cache(cfg, batch, max_len, device)
    if cfg.family == "xlstm":
        return xlstm.init_cache(cfg, batch, device)
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_len, enc_len, device)
    return attention.init_cache(cfg, batch, max_len, cfg.n_layers,
                                device=device)


def cache_specs(cfg: ModelConfig):
    """Logical specs with the structure of :func:`init_cache`'s cache."""
    _check(cfg)
    if cfg.family == "mamba_hybrid":
        return zamba2.cache_specs(cfg)
    if cfg.family == "xlstm":
        return xlstm.cache_specs(cfg)
    if cfg.family == "encdec":
        return encdec.cache_specs(cfg)
    cs = attention.cache_specs(cfg)
    return attention.KVCache(cs, cs)


@torch.no_grad()
def prefill(cfg: ModelConfig, model: transformer.Model, batch, max_len: int):
    """Returns (logits (B, V), cache, lengths (B,)).  ``encdec`` encodes
    ``batch["frames"]`` and fills the cross K/V, then returns zero logits
    and zero lengths, as the reference does: its decoder never reads the
    prompt."""
    _check(cfg)
    params = model.serving_params()
    tokens = batch["tokens"]
    if cfg.family == "mamba_hybrid":
        return zamba2.prefill(cfg, params, tokens, max_len)
    if cfg.family == "xlstm":
        return xlstm.prefill(cfg, params, tokens)
    if cfg.family == "encdec":
        frames = batch["frames"]
        b, t = frames.shape[:2]
        dev = frames.device
        enc_out = encdec.encode(cfg, params, frames)
        ck, cv, el = encdec.prefill_cross(
            cfg, params, enc_out,
            torch.full((b,), t, dtype=torch.int32, device=dev))
        cache = dict(encdec.init_cache(cfg, b, max_len, t, dev),
                     cross_k=ck, cross_v=cv, enc_len=el)
        return (torch.zeros((b, cfg.vocab), dtype=cfg.dtype, device=dev),
                cache, torch.zeros((b,), dtype=torch.int32, device=dev))
    if cfg.family == "vlm":
        return vlm.prefill(cfg, params, batch["patches"], tokens, max_len)
    return transformer.prefill(cfg, params, tokens, max_len=max_len)


@torch.no_grad()
def decode(cfg: ModelConfig, model: transformer.Model, cache, token,
           lengths):
    """One decode step: (logits (B, V), cache, lengths + 1).  A KV cache is
    written in place; xlstm's recurrent state comes back new."""
    _check(cfg)
    params = model.serving_params()
    if cfg.family == "mamba_hybrid":
        return zamba2.decode_step(cfg, params, cache, token, lengths)
    if cfg.family == "xlstm":
        return xlstm.decode_step(cfg, params, cache, token, lengths)
    if cfg.family == "encdec":
        return encdec.decode_step(cfg, params, cache, token, lengths)
    return transformer.decode_step(cfg, params, cache, token, lengths)
