"""Decoder-only transformer (dense GQA or MoE FFN): training loss, prefill
and decode.

The port of ``repro/models/transformer.py``.  :class:`Transformer` is an
``nn.Module`` that holds the parameters at ``cfg.param_dtype`` in a
``ModuleList`` of blocks; a Python loop over the blocks takes the place
of ``lax.scan``, and ``remat`` (``jax.checkpoint`` of each block) is
``torch.utils.checkpoint`` of each block, non-reentrant, when a gradient
is wanted.  The functions below take the same
nested dicts of tensors as the reference's pytrees (one dict per layer in
``params["blocks"]``).  Dense projections, the router and the
unembedding are plain products, as the reference leaves them to XLA;
attention and the expert GEMMs run through the hand-written kernels.
A float32 model computes in float32 on the card only with TF32 off,
which the entry points that own the process set
(:func:`repro_torch.launch.serve.float32_matmuls`).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention, moe
from .common import (ModelConfig, dense_init, embed_init, rms_norm,
                     softmax_cross_entropy, swiglu)


def _is_moe(cfg: ModelConfig) -> bool:
    return cfg.family == "moe" or bool(cfg.num_experts)


def block_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    p = {"attn": attention.attn_params(gen, cfg, device),
         "ln_attn": torch.ones(cfg.d_model, dtype=cfg.param_dtype,
                               device=device),
         "ln_mlp": torch.ones(cfg.d_model, dtype=cfg.param_dtype,
                              device=device)}
    if _is_moe(cfg):
        p["moe"] = moe.moe_params(gen, cfg, device)
    else:
        d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
        p["mlp"] = {"w_in": dense_init(gen, (d, f), 0, pd, device),
                    "w_gate": dense_init(gen, (d, f), 0, pd, device),
                    "w_out": dense_init(gen, (f, d), 0, pd, device)}
    return p


def tree_map(fn, tree):
    """``fn`` of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def cast(tree, dtype: torch.dtype):
    """Every tensor of a parameter tree at ``dtype``."""
    return tree_map(lambda t: t.detach().to(dtype), tree)


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None, *,
                dtype=None) -> dict:
    """The reference's draws at ``cfg.param_dtype``; with ``dtype``, each
    tensor is cast to it as soon as it is drawn, so the tree at
    ``param_dtype`` is never held whole."""
    keep = (lambda t: t) if dtype is None else (lambda t: cast(t, dtype))
    params = {
        "embed": keep(embed_init(gen, (cfg.vocab, cfg.d_model),
                                 cfg.param_dtype, device)),
        "blocks": [keep(block_params(gen, cfg, device))
                   for _ in range(cfg.n_layers)],
        "ln_f": keep(torch.ones(cfg.d_model, dtype=cfg.param_dtype,
                                device=device)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = keep(embed_init(gen, (cfg.d_model, cfg.vocab),
                                            cfg.param_dtype, device))
    return params


def _ffn(cfg: ModelConfig, p, h):
    if "moe" in p:
        return moe.moe_apply(cfg, p["moe"], h)
    m = p["mlp"]
    return swiglu(h, m["w_in"].to(h.dtype), m["w_gate"].to(h.dtype),
                  m["w_out"].to(h.dtype))


def block_apply(cfg: ModelConfig, p, x, positions, *, return_kv=False):
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    a = attention.attend(cfg, p["attn"], h, positions, return_kv=return_kv)
    if return_kv:
        a, kv = a
    x = x + a
    x = x + _ffn(cfg, p, rms_norm(x, p["ln_mlp"], cfg.norm_eps))
    return (x, kv) if return_kv else x


def unembed(cfg: ModelConfig, params, x):
    w = params.get("unembed")
    if w is None:
        w = params["embed"].T
    return x @ w.to(cfg.dtype)


def _embed(cfg: ModelConfig, params, tokens):
    return params["embed"].to(cfg.dtype)[tokens]


def run_stack(cfg: ModelConfig, blocks, x, positions):
    """The blocks in order; with ``cfg.remat`` and a gradient wanted,
    each block under a non-reentrant ``checkpoint``: its activations are
    rebuilt in the backward (the recompute routes the same experts:
    ``moe.top_k`` is a stable sort)."""
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in blocks:
        if remat:
            x = checkpoint(block_apply, cfg, lp, x, positions,
                           use_reentrant=False)
        else:
            x = block_apply(cfg, lp, x, positions)
    return x


def forward(cfg: ModelConfig, params, tokens, *, positions=None):
    """tokens: (B, S).  Returns logits (B, S, V)."""
    x = _embed(cfg, params, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    x = run_stack(cfg, params["blocks"], x, positions)
    return unembed(cfg, params, rms_norm(x, params["ln_f"], cfg.norm_eps))


def loss_fn(cfg: ModelConfig, params, tokens, *, mask=None):
    """Next-token cross-entropy of ``tokens`` (B, S): logits of the first
    S - 1 positions against the last S - 1 tokens (float32 log-softmax),
    averaged, or over ``mask``'s last S - 1 positions."""
    tokens = tokens.long()
    logits = forward(cfg, params, tokens[:, :-1])
    m = mask[:, 1:] if mask is not None else None
    return softmax_cross_entropy(logits, tokens[:, 1:], m)


def prefill(cfg: ModelConfig, params, tokens, *, max_len=None):
    """Forward pass that also builds the KV cache.

    Returns (last-token logits (B, V), KVCache (L, B, KV, max_len, hd),
    lengths (B,)).
    """
    x = _embed(cfg, params, tokens)
    b, s = x.shape[:2]
    max_len = max_len or s
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = attention.init_cache(cfg, b, max_len, len(params["blocks"]),
                                 dtype=x.dtype, device=x.device)
    for i, lp in enumerate(params["blocks"]):
        x, (k, v) = block_apply(cfg, lp, x, positions, return_kv=True)
        cache.k[i, :, :, :s] = k
        cache.v[i, :, :, :s] = v
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(cfg, params, x[:, -1])
    return logits, cache, torch.full((b,), s, dtype=torch.int32,
                                     device=x.device)


def block_decode(cfg: ModelConfig, p, x, layer_cache, lengths):
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    a, new_cache = attention.attend_decode(cfg, p["attn"], h, layer_cache,
                                           lengths)
    x = x + a
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    if "moe" in p:
        return x + moe.moe_apply(cfg, p["moe"], h[:, None, :])[:, 0], new_cache
    return x + _ffn(cfg, p, h), new_cache


def decode_step(cfg: ModelConfig, params, cache: attention.KVCache, token,
                lengths):
    """One decode step.  token: (B,); lengths: (B,).  The cache is
    updated in place.  Returns (logits (B, V), cache, lengths + 1)."""
    x = _embed(cfg, params, token)
    for i, lp in enumerate(params["blocks"]):
        x, _ = block_decode(cfg, lp, x,
                            attention.KVCache(cache.k[i], cache.v[i]),
                            lengths)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(cfg, params, x), cache, lengths + 1


# --------------------------------------------------------------------------
# The module
# --------------------------------------------------------------------------

def _module(tree) -> nn.Module:
    """Nested dicts of tensors as an ``nn.Module`` (parameters frozen)."""
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _module(v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return m


def _tree(m: nn.Module) -> dict:
    out = {k: p for k, p in m.named_parameters(recurse=False)}
    out.update({k: _tree(c) for k, c in m.named_children()})
    return out


class Transformer(nn.Module):
    """The model's parameters (``embed``, ``blocks``, ``ln_f`` and, unless
    tied, ``unembed``) with :meth:`prefill` and :meth:`decode_step` over
    a serving copy at ``cfg.dtype`` (the reference casts each weight at
    each use).  The parameters are given at ``cfg.param_dtype`` (the
    master copy, kept beside the serving copy) or, for a model that only
    serves, already at ``cfg.dtype``: then they are the serving copy and
    no second one is made.  The serving copy is made again whenever a
    parameter has changed since it was cast (a training step updates the
    master copy in place, which moves each tensor's version counter).

    The parameters do not require gradients until ``requires_grad_()``
    (the training step calls it); the loss is :func:`loss_fn` over
    :meth:`params`."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(_module(b) for b in params["blocks"])
        for k in ("embed", "ln_f", "unembed"):
            if k in params:
                self.register_parameter(
                    k, nn.Parameter(params[k], requires_grad=False))
        self._serving = None
        self._serving_key = None

    @classmethod
    def init(cls, cfg: ModelConfig, gen: torch.Generator, device=None, *,
             keep_master: bool = True):
        """Draw the parameters; ``keep_master=False`` holds them at
        ``cfg.dtype`` only (a model that serves and never trains)."""
        return cls(cfg, init_params(gen, cfg, device,
                                    dtype=None if keep_master else cfg.dtype))

    def params(self) -> dict:
        """The parameters as the reference's tree (one dict per layer)."""
        out = {k: p for k, p in self.named_parameters(recurse=False)}
        out["blocks"] = [_tree(b) for b in self.blocks]
        return out

    def _versions(self) -> tuple:
        return tuple((p.data_ptr(), p._version) for p in self.parameters())

    def serving_params(self) -> dict:
        """The parameters at ``cfg.dtype`` (the parameters themselves
        where they are at that type already), cast at first use and again
        after any parameter has changed."""
        key = self._versions()
        if self._serving is None or key != self._serving_key:
            self._serving = None             # drop the old copy first
            self._serving = cast(self.params(), self.cfg.dtype)
            self._serving_key = key
        return self._serving

    @torch.no_grad()
    def prefill(self, tokens, max_len=None):
        return prefill(self.cfg, self.serving_params(), tokens,
                       max_len=max_len)

    @torch.no_grad()
    def decode_step(self, cache, token, lengths):
        return decode_step(self.cfg, self.serving_params(), cache, token,
                           lengths)
