"""Mixture-of-experts FFN with capacity-based dispatch.

The port of ``repro/models/moe.py``, in both routing modes
(``expert_choice``, the default, and ``token_dense``, the exact oracle).
Each of the three expert GEMMs is one launch of the hand-written
:func:`repro_torch.kernels.wavefront_matmul.ops.wavefront_matmul` over
all experts, with the expert's rows in 128-row tiles; a tile that holds
no routed token (``token_dense`` only) is inactive and skipped.

Two rules keep a run repeatable and equal to the reference:

* top-k takes the lowest index first among equal scores, as
  ``jax.lax.top_k`` does (:func:`top_k`, a stable descending sort);
  ``torch.topk`` promises no order for ties;
* the expert-choice combine adds the experts' rows into the output in
  expert order, one rounding per add, as the reference's scatter-add
  does; each expert's rows go to distinct tokens, so no add races.

The gradient follows the same rule: the gather of the experts' tokens
(``flat[topi]``) backpropagates by the same expert-ordered adds (a token
chosen by several experts sums their gradients in expert order, so the
step repeats bit for bit), and the combine by a gather.  Both go through
their ``torch.autograd.Function`` only when a gradient is wanted, so a
run under ``no_grad`` (the serve) makes the ops it made before.  Under
``remat`` the recompute chooses the same experts: :func:`top_k` is a
stable sort of the same gates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.wavefront_matmul.ops import TILE_M, wavefront_matmul
from .common import ModelConfig, dense_init, is_dtensor

MODES = ("expert_choice", "token_dense")


def moe_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    pd = cfg.param_dtype
    return {
        "router": dense_init(gen, (d, e), 0, pd, device),
        "w_in": dense_init(gen, (e, d, f), 1, pd, device),
        "w_gate": dense_init(gen, (e, d, f), 1, pd, device),
        "w_out": dense_init(gen, (e, f, d), 1, pd, device),
    }


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values,
    equal values in ascending index order."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _expert_ffn(p, xe, dtype, active):
    """xe: (E, C, d) -> (E, C, d); ``active``: (E, ceil(C / 128)) tiles."""
    h = wavefront_matmul(xe, p["w_in"].to(dtype), active)
    g = wavefront_matmul(xe, p["w_gate"].to(dtype), active)
    return wavefront_matmul(F.silu(g) * h, p["w_out"].to(dtype), active)


def route(cfg: ModelConfig, p, flat, *, mode: str = "expert_choice",
          capacity_factor: float = 1.0):
    """Gate probabilities and the routing choice for tokens ``flat``
    (N, d): ``(topv, topi)``, (E, C) per expert for ``expert_choice``,
    (N, k) per token for ``token_dense``."""
    if mode not in MODES:
        raise ValueError(f"unknown MoE mode {mode!r}")
    gate_logits = flat @ p["router"].to(flat.dtype)
    gates = torch.softmax(gate_logits.float(), dim=-1)
    if mode == "token_dense":
        return top_k(gates, cfg.top_k)
    n, e = flat.shape[0], cfg.num_experts
    cap = max(1, int(round(n * cfg.top_k * capacity_factor / e)))
    return top_k(gates.T, cap)


def _add_rows(out, topi, rows):
    """``out[topi[i]] += rows[i]`` for experts i = 0, 1, ... in order:
    ``topi`` (E, C) holds distinct tokens per expert, ``rows`` (E, C, d).
    Returns ``out``, written in place."""
    for i in range(topi.shape[0]):       # expert 0 first, as the reference
        out[topi[i]] += rows[i]          # distinct tokens: one add each
    return out


def _gather(flat, topi):
    """``flat[topi]``: (E, C, d)."""
    return flat[topi]


def _combine(ye, topi, n):
    """The expert-ordered adds of ``ye`` (E, C, d) into (N, d).  In a
    partitioned step (``DTensor``s), each rank makes the adds whole on
    replicas of ``ye`` and ``topi`` (an all-gather where they are
    sharded): ``topi`` holds tokens of the whole batch, and DTensor has no
    rule for an in-place ``index_put_`` that scatters rows across
    shards."""
    if is_dtensor(ye):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = ye.device_mesh
        whole = [Replicate()] * mesh.ndim
        out = _combine(ye.redistribute(mesh, whole).to_local(),
                       topi.redistribute(mesh, whole).to_local(), n)
        return DTensor.from_local(out, mesh, whole, run_check=False)
    return _add_rows(ye.new_zeros((n,) + ye.shape[2:]), topi, ye)


class _Gather(torch.autograd.Function):
    """:func:`_gather`; its gradient adds in expert order."""

    @staticmethod
    def forward(ctx, flat, topi):
        ctx.save_for_backward(topi)
        ctx.n = flat.shape[0]
        return _gather(flat, topi)

    @staticmethod
    def backward(ctx, g):
        topi, = ctx.saved_tensors
        return _combine(g, topi, ctx.n), None


class _Combine(torch.autograd.Function):
    """:func:`_combine`; its gradient is the gather."""

    @staticmethod
    def forward(ctx, ye, topi, n):
        ctx.save_for_backward(topi)
        return _combine(ye, topi, n)

    @staticmethod
    def backward(ctx, g):
        topi, = ctx.saved_tensors
        return _gather(g, topi), None, None


def _grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def aux_load_balance_loss(gate_logits_f32: torch.Tensor,
                          top_k: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (per batch of logits).
    The reference's loss never calls it, so neither does the port's."""
    gates = torch.softmax(gate_logits_f32, dim=-1)
    e = gates.shape[-1]
    frac_routed = torch.mean(
        F.one_hot(torch.argmax(gates, -1), e).float(), dim=0)
    frac_gate = torch.mean(gates, dim=0)
    return e * torch.sum(frac_routed * frac_gate)


def moe_apply(cfg: ModelConfig, p, x, *, mode: str = "expert_choice",
              capacity_factor: float = 1.0):
    """x: (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    n, e = b * s, cfg.num_experts
    flat = x.reshape(n, d)
    topv, topi = route(cfg, p, flat, mode=mode,
                       capacity_factor=capacity_factor)

    if mode == "token_dense":
        topv = topv / topv.sum(-1, keepdim=True)
        combine = torch.zeros((n, e), dtype=torch.float32, device=x.device)
        combine.scatter_add_(1, topi, topv)
        xe = combine.T.to(x.dtype)[:, :, None] * flat[None]   # (E, N, d)
        tiles = -(-n // TILE_M)
        routed = F.pad(combine.T != 0, (0, tiles * TILE_M - n))
        active = routed.reshape(e, tiles, TILE_M).any(-1)
        ye = _expert_ffn(p, xe, x.dtype, active)
        return ye.sum(0).reshape(b, s, d)                   # already weighted

    cap = topi.shape[1]
    xe = _Gather.apply(flat, topi) if _grad(flat) else _gather(flat, topi)
    active = torch.ones((e, -(-cap // TILE_M)), dtype=torch.int32,
                        device=x.device)
    ye = _expert_ffn(p, xe, x.dtype, active)
    ye = ye * topv[..., None].to(x.dtype)
    out = _Combine.apply(ye, topi, n) if _grad(ye) else _combine(ye, topi, n)
    return out.reshape(b, s, d)
