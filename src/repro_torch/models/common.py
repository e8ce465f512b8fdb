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


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``torch.distributed.tensor.DTensor`` (without
    importing that package where nothing has)."""
    import sys
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def full_like_batch(like, shape, fill, dtype, batch_dim: int = 0):
    """``torch.full(shape, fill)`` on ``like``'s device, for a state or
    cache of ``like``'s batch (its dim 0) at dim ``batch_dim``.  Where
    ``like`` is a ``DTensor`` (the step run as a partitioned program), a
    ``DTensor`` whose dim ``batch_dim`` is placed as ``like``'s dim 0 and
    every other dim replicated: each rank makes its own batch rows."""
    if not is_dtensor(like):
        return torch.full(shape, fill, dtype=dtype, device=like.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    place = [Shard(batch_dim) if isinstance(p, Shard) and p.dim == 0
             else Replicate() for p in like.placements]
    mine = like.to_local()
    local = list(shape)
    local[batch_dim] = mine.shape[0]
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(
        torch.full(local, fill, dtype=dtype, device=mine.device),
        like.device_mesh, place, run_check=False, shape=torch.Size(shape),
        stride=tuple(stride))


def batch_only(x, like=None):
    """``x``; a ``DTensor`` placed on its batch (dim 0) alone, as ``like``
    (by default ``x`` itself) places its dim 0, and replicated over every
    other mesh dim (a collective where it was placed otherwise), so that
    what follows is batch-parallel: the residual stream from the
    embeddings on, the SSD's and the xLSTM cells' chunked einsums (whose
    contracted dims DTensor would otherwise leave sharded, and all-reduce
    their (B, H, NC, CL, CL) products)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in (x if like is None else like).placements]
    return x if want == list(x.placements) else x.redistribute(
        x.device_mesh, want)


class _ContiguousGrad(torch.autograd.Function):
    """The identity on a ``DTensor``, whose gradient's shard is made
    contiguous (the gradient's own ``contiguous()`` looks at its global
    strides and leaves the shard as it is)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(g.to_local().contiguous(), g.device_mesh,
                                  g.placements, run_check=False,
                                  shape=g.shape, stride=g.stride())


def contiguous_grad(y):
    """``y``; for a ``DTensor``, its gradient's shard made contiguous (on
    2 x 16 x 16, where the batch spans two mesh dims, DTensor can hand a
    product's backward a gradient shard that is a strided view, which
    that backward's ``view`` cannot take)."""
    return _ContiguousGrad.apply(y) if is_dtensor(y) else y


def batch_local(fn, *xs):
    """``fn(*xs)``; where ``xs`` are ``DTensor``s, each placed on its batch
    alone (:func:`batch_only`, as ``xs[0]`` places its dim 0), ``fn`` run
    on this rank's shards and its output a ``DTensor`` placed as they are
    (its gradient placed so too): a batch-parallel layer computed as on
    one device, forward and backward.  DTensor's own propagation of
    xlstm's mLSTM on 2 x 16 x 16 shards a product's batch dim over every
    mesh dim in the backward, which its ``view`` back cannot take."""
    if not any(is_dtensor(x) for x in xs):
        return fn(*xs)
    from torch.distributed.tensor import DTensor
    xs = [batch_only(x, xs[0]) for x in xs]
    return DTensor.from_local(fn(*(x.to_local() for x in xs)),
                              xs[0].device_mesh, xs[0].placements,
                              run_check=False)


#: the mesh dims that shard a weight's ``fsdp`` dim and the batch
BATCH_MESH_DIMS = ("pod", "data")


def gather_fsdp(tree):
    """A layer's weights (a dict or list of tensors) as its operations
    use them: in a partitioned step, each ``DTensor`` gathered over the
    mesh dims of :data:`BATCH_MESH_DIMS` (ZeRO-3's all-gather before use;
    its gradient comes back through a reduce-scatter), its ``model``
    placement kept.  A plain tensor is itself."""
    if isinstance(tree, dict):
        return {k: gather_fsdp(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_fsdp(v) for v in tree]
    if not is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Replicate
    names = tree.device_mesh.mesh_dim_names or ()
    want = [Replicate() if n in BATCH_MESH_DIMS else p
            for n, p in zip(names, tree.placements)]
    return tree if want == list(tree.placements) else tree.redistribute(
        tree.device_mesh, want)


def embed(cfg: ModelConfig, params, tokens):
    """The embeddings of ``tokens`` at ``cfg.dtype``.  In a partitioned
    step (``DTensor``) the table is looked up whole (gathered where it is
    sharded: DTensor's masked lookup of a vocabulary shard leaves a
    partial sum whose gradient it cannot always place) and the result
    placed on the batch alone (:func:`batch_only`), so that the residual
    stream is batch-parallel."""
    table = params["embed"]
    if is_dtensor(table):
        from torch.distributed.tensor import Replicate
        table = table.redistribute(table.device_mesh,
                                   [Replicate()] * table.device_mesh.ndim)
    return batch_only(F.embedding(tokens, table.to(cfg.dtype)), tokens)


def split_dim(y, dim: int, *sizes):
    """``y.unflatten(dim, sizes)``.  A ``DTensor`` whose dim ``dim`` is
    sharded over mesh dims whose shards would cut a ``sizes[0]`` group
    apart is first replicated over those mesh dims (DTensor refuses to
    unflatten an uneven shard)."""
    dim %= y.ndim
    if is_dtensor(y):
        from torch.distributed.tensor import Replicate, Shard
        cut = lambda p: isinstance(p, Shard) and p.dim == dim
        n = 1
        for i, p in enumerate(y.placements):
            n *= y.device_mesh.shape[i] if cut(p) else 1
        if sizes[0] % n:
            y = y.redistribute(y.device_mesh, [
                Replicate() if cut(p) else p for p in y.placements])
    return y.unflatten(dim, sizes)


class _Merge(torch.autograd.Function):
    """``y.flatten(dim, dim + 1)`` whose gradient is unflattened by
    :func:`split_dim`."""

    @staticmethod
    def forward(ctx, y, dim):
        ctx.dim, ctx.sizes = dim, y.shape[dim:dim + 2]
        return y.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, *ctx.sizes), None


def merge_dims(y, dim: int):
    """``y.flatten(dim, dim + 1)``; for a ``DTensor``, its gradient is
    unflattened by :func:`split_dim` (DTensor may have sharded the
    gradient where it cannot split it)."""
    dim %= y.ndim
    return _Merge.apply(y, dim) if is_dtensor(y) else y.flatten(dim, dim + 1)


def softmax_cross_entropy(logits, targets, mask=None):
    """logits: (B, S, V); the mean negative log-likelihood of ``targets``
    (B, S) under a float32 log-softmax (their sum over their count), or
    its mean over ``mask``.  In a partitioned step (``DTensor``s), each
    rank takes its own rows (:func:`_cross_entropy_rows`)."""
    if is_dtensor(logits):
        return _cross_entropy_rows(logits, targets, mask)
    nll = _nll(logits, targets)
    if mask is None:
        return torch.sum(nll) / nll.numel()
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _nll(logits, targets):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return logz - gold


def _cross_entropy_rows(logits, targets, mask):
    """:func:`softmax_cross_entropy` of ``DTensor`` logits: the logits
    placed on the batch alone (the vocabulary gathered where it is
    sharded), ``targets`` and ``mask`` as their batch, each rank's sums
    of its own rows a partial sum over the batch's mesh dims.  The rows'
    operations run on plain local tensors, so their gradient needs no
    DTensor rule (a gold logit's ``gather`` over a sharded vocabulary has
    none that holds, in some torch versions)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    logits = batch_only(logits)
    mesh = logits.device_mesh
    rows = [p if isinstance(p, Shard) else Replicate()
            for p in logits.placements]
    total = [Partial() if isinstance(p, Shard) else Replicate()
             for p in logits.placements]

    def local(t):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, rows).to_local()

    def summed(t):
        return DTensor.from_local(torch.sum(t), mesh, total, run_check=False)

    nll = _nll(logits.to_local(), local(targets))
    if mask is None:
        return summed(nll) / targets.numel()
    mask = local(mask).float()
    return summed(nll * mask) / torch.clamp(summed(mask), min=1.0)


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
