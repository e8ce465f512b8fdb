"""Decoder-only transformer (dense GQA or MoE FFN): training loss, prefill
and decode.

The port of ``repro/models/transformer.py``.  :class:`Model`, the base
of every family's model, is an ``nn.Module`` that holds a parameter
tree at ``cfg.param_dtype`` (a layer list as a ``ModuleList``) and its
serving copy; :class:`Transformer` is this family's.  A Python loop
over the blocks takes the place
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


#: a dense block's SwiGLU MLP
MLP_SPECS = {"w_in": ("fsdp", "ff"), "w_gate": ("fsdp", "ff"),
             "w_out": ("ff", "fsdp")}


def block_specs(cfg: ModelConfig) -> dict:
    """Logical sharding specs of one block, mirroring :func:`block_params`."""
    specs = {"attn": attention.attn_specs(),
             "ln_attn": (None,), "ln_mlp": (None,)}
    if _is_moe(cfg):
        specs["moe"] = {"router": ("fsdp", None),
                        "w_in": ("experts", "fsdp", "expert_ff"),
                        "w_gate": ("experts", "fsdp", "expert_ff"),
                        "w_out": ("experts", "expert_ff", "fsdp")}
    else:
        specs["mlp"] = MLP_SPECS
    return specs


def param_specs(cfg: ModelConfig) -> dict:
    """Logical sharding specs, mirroring :func:`init_params` (one dict of
    :func:`block_specs` a layer)."""
    specs = {"embed": ("vocab", "fsdp"),
             "blocks": [block_specs(cfg) for _ in range(cfg.n_layers)],
             "ln_f": (None,)}
    if not cfg.tie_embeddings:
        specs["unembed"] = ("fsdp", "vocab")
    return specs


def tree_map(fn, tree, *rest):
    """``fn`` of every leaf of a tree of dicts, lists and named tuples
    (and of the same leaf of each tree of ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and hasattr(tree, "_fields")):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(*out)
    return fn(tree, *rest)


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


def block_apply(cfg: ModelConfig, p, x, positions, *, causal=True,
                kv_lengths=None, return_kv=False):
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    a = attention.attend(cfg, p["attn"], h, positions, causal=causal,
                         kv_lengths=kv_lengths, return_kv=return_kv)
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


def _inputs(cfg: ModelConfig, params, tokens, embeds):
    """The stack's input: ``embeds`` (B, S, d) at ``cfg.dtype`` where
    given, else the embeddings of ``tokens``."""
    if embeds is not None:
        return embeds.to(cfg.dtype)
    return _embed(cfg, params, tokens)


def forward(cfg: ModelConfig, params, tokens, *, embeds=None, positions=None):
    """tokens: (B, S) (or ``embeds``: (B, S, d)).  Returns logits
    (B, S, V)."""
    x = _inputs(cfg, params, tokens, embeds)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    x = run_stack(cfg, params["blocks"], x, positions)
    return unembed(cfg, params, rms_norm(x, params["ln_f"], cfg.norm_eps))


def loss_fn(cfg: ModelConfig, params, tokens, *, embeds=None, mask=None):
    """Next-token cross-entropy of ``tokens`` (B, S): logits of the first
    S - 1 positions (of ``embeds``' first S - 1 where given) against the
    last S - 1 tokens (float32 log-softmax), averaged, or over ``mask``'s
    last S - 1 positions."""
    tokens = tokens.long()
    logits = forward(cfg, params, tokens[:, :-1],
                     embeds=None if embeds is None else embeds[:, :-1])
    m = mask[:, 1:] if mask is not None else None
    return softmax_cross_entropy(logits, tokens[:, 1:], m)


def prefill(cfg: ModelConfig, params, tokens, *, embeds=None, max_len=None):
    """Forward pass that also builds the KV cache; ``embeds`` (B, S, d) in
    place of ``tokens``' embeddings where given.

    Returns (last-token logits (B, V), KVCache (L, B, KV, max_len, hd),
    lengths (B,)).
    """
    x = _inputs(cfg, params, tokens, embeds)
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
    """A tree of dicts and lists of tensors as an ``nn.Module``: a dict as
    a module of its keys, a list (of dicts) as an ``nn.ModuleList``, a
    tensor as a frozen parameter."""
    if isinstance(tree, list):
        return nn.ModuleList(_module(v) for v in tree)
    m = nn.Module()
    _register(m, tree)
    return m


def _register(m: nn.Module, tree: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            m.add_module(k, _module(v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))


def _tree(m: nn.Module):
    """The inverse of :func:`_module`."""
    if isinstance(m, nn.ModuleList):
        return [_tree(c) for c in m]
    out = {k: p for k, p in m.named_parameters(recurse=False)}
    out.update({k: _tree(c) for k, c in m.named_children()})
    return out


class Model(nn.Module):
    """A model's parameters, any tree of dicts and lists of tensors in the
    reference's layout (with one dict per layer where the reference
    stacks layers), as an ``nn.Module``, with a serving copy at
    ``cfg.dtype`` (the reference casts each weight at each use).  The
    parameters are given at ``cfg.param_dtype`` (the master copy, kept
    beside the serving copy) or, for a model that only serves, already at
    ``cfg.dtype``: then they are the serving copy and no second one is
    made.  The serving copy is made again whenever a parameter has
    changed since it was cast (a training step updates the master copy
    in place, which moves each tensor's version counter).

    The parameters do not require gradients until ``requires_grad_()``
    (the training step calls it); each family's loss is a function of
    :meth:`params` (``models.api.loss``)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        _register(self, params)
        self._serving = None
        self._serving_key = None

    def params(self) -> dict:
        """The parameters as the reference's tree (one dict per layer)."""
        return _tree(self)

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


class Transformer(Model):
    """A ``dense`` or ``moe`` model: ``embed``, ``blocks``, ``ln_f`` and,
    unless tied, ``unembed``."""

    @classmethod
    def init(cls, cfg: ModelConfig, gen: torch.Generator, device=None, *,
             keep_master: bool = True):
        """Draw the parameters; ``keep_master=False`` holds them at
        ``cfg.dtype`` only (a model that serves and never trains)."""
        return cls(cfg, init_params(gen, cfg, device,
                                    dtype=None if keep_master else cfg.dtype))

    @torch.no_grad()
    def prefill(self, tokens, max_len=None):
        return prefill(self.cfg, self.serving_params(), tokens,
                       max_len=max_len)

    @torch.no_grad()
    def decode_step(self, cache, token, lengths):
        return decode_step(self.cfg, self.serving_params(), cache, token,
                           lengths)
