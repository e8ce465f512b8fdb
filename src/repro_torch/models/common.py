"""Shared model components: config, initialisers, norms, rotary, SwiGLU,
the cross-entropy loss.

The port of ``repro/models/common.py``: the same ``ModelConfig`` fields
with torch dtypes, and the same functions on tensors.  Initialisers take
an explicit ``torch.Generator`` (which gives other numbers than
``jax.random`` for one seed; tests feed both packages one set of numpy
weights through :mod:`.convert`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture (exact values live in ``repro_torch/configs``)."""

    name: str
    family: str                 # dense | moe | mamba_hybrid | xlstm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # MoE
    num_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    shared_attn_period: int = 0   # zamba2: shared block every k layers
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # vlm
    num_patches: int = 0
    # numerics / execution
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    remat: bool = True          # training only; serving ignores it
    scan_layers: bool = True    # the port loops over layers in Python
    tie_embeddings: bool = False
    logits_chunk: int = 0       # 0 = unchunked loss
    max_seq: int = 8192

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def supports_long_context(self) -> bool:
        return self.family in ("mamba_hybrid", "xlstm")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Initialisers: an explicit generator; leaves are created at ``dtype``.
# --------------------------------------------------------------------------

def fan_in(shape, in_axis) -> int:
    if isinstance(in_axis, int):
        return int(shape[in_axis])
    return int(np.prod([shape[a] for a in in_axis]))


def dense_init(gen: torch.Generator, shape, in_axis=0, dtype=torch.float32,
               device=None) -> torch.Tensor:
    std = 1.0 / np.sqrt(max(1, fan_in(shape, in_axis)))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * 0.02).to(dtype)


# --------------------------------------------------------------------------
# Primitive layers (functions over dicts of tensors)
# --------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rotary(x, positions, theta: float = 1e4):
    """x: (..., S, H, D) with D even; positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].float() * freqs           # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x):
    """``jax.nn.silu`` as the reference computes it: ``x * 1 / (1 +
    exp(-x))``, each operation rounded to ``x``'s type.  In bfloat16 that
    is XLA's expansion, bit for bit, and differs from a once-rounded
    ``F.silu`` in about 4 of 10 values (one ulp); the SSD's and the
    mLSTM's ``y * silu(z)`` carry that ulp into sums of large terms."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(x, w_in, w_gate, w_out):
    h = x @ w_in
    g = x @ w_gate
    return (F.silu(g) * h) @ w_out


def softmax_cross_entropy(logits, targets, mask=None):
    """logits: (B, S, V); the mean negative log-likelihood of ``targets``
    (B, S) under a float32 log-softmax, or its mean over ``mask``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# --------------------------------------------------------------------------
# Logical sharding axis names (resolved by repro_torch.sharding.partition)
# --------------------------------------------------------------------------
# "batch"       — data-parallel batch            -> ("pod","data")
# "fsdp"        — parameter shard (ZeRO)          -> "data" (when enabled)
# "heads"       — attention heads                 -> "model" (if divisible)
# "kv_heads"    — KV heads of the projections     -> "model" (if both divide)
# "hd"          — attention head_dim              -> replicated
# "ff"          — MLP hidden                      -> "model"
# "heads2"      — xLSTM inner->inner outputs      -> replicated
# "vocab"       — embedding rows                  -> "model" (if divisible)
# "experts"     — MoE expert dim                  -> "model" (if divisible)
# "expert_ff"   — per-expert ffn dim              -> "model" (else)
# "seq"         — sequence (SP / cache)           -> "model"
# "cache_heads" — KV heads of a cache             -> "model" (when chosen)
# None          — replicated
# The reference stacks a part's layers on a leading "layers" axis (always
# replicated); the port keeps one dict a layer, so its per-layer specs
# have no such entry.
