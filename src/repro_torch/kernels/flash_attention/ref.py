"""Plain PyTorch version of blocked causal/ragged attention and of its
gradient.

It mirrors ``repro/kernels/flash_attention/ref.py`` (``mha_ref``) and
adds grouped-query attention: ``k`` and ``v`` may have fewer heads than
``q``, and query head ``h`` reads key/value head ``h // G`` with
``G = H / KV``.  With ``KV == H`` it is the reference's function.
:func:`mha_ref_bwd` is the gradient written out (the reference has no
backward kernel: XLA differentiates its jnp attention), and
:func:`mha_ref_lse` the non-causal attention with each row's log-sum-exp
beside it (the partial result that merges across key shards).  All
compute in float32, or in float64 for float64 inputs.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the type the plain versions compute in: float32, or
    float64 for float64 inputs."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _mask(b: int, sq: int, sk: int, lengths, causal: bool, dev):
    """Live (query, key) pairs, broadcastable to (B, KV, G, Sq, Sk)."""
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask = (torch.arange(sk, device=dev)[None, :]
                <= torch.arange(sq, device=dev)[:, None] + (sk - sq))
    mask = mask.expand(b, 1, 1, sq, sk)
    if lengths is not None:
        lmask = (torch.arange(sk, device=dev)
                 < lengths.to(dev)[:, None, None, None, None])
        mask = mask & lmask
    return mask


def _probs(q, k, lengths, causal):
    """(P, mask): softmax weights (B, KV, G, Sq, Sk), zero where masked,
    as the forward computes them."""
    b, kv, g, sq, d = q.shape
    sk = k.shape[-2]
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    mask = _mask(b, sq, sk, lengths, causal, q.device)
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = torch.where(mask, w, 0.0)
    denom = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-30)
    return w / denom, mask


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lengths: torch.Tensor | None = None,
            causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, D), k/v: (B, KV, Sk, D), lengths: (B,) valid kv
    length.  Returns (B, H, Sq, D) float32.  Causal alignment is
    decode-style: query i attends to kv positions <= i + (Sk - Sq)."""
    b, h, sq, d = q.shape
    kv = k.shape[1]
    q = _acc(q).reshape(b, kv, h // kv, sq, d)
    k, v = _acc(k)[:, :, None], _acc(v)[:, :, None]
    p, _ = _probs(q, k, lengths, causal)
    return torch.matmul(p, v).reshape(b, h, sq, d)


def mha_ref_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor | None = None):
    """Non-causal :func:`mha_ref` and each row's log-sum-exp of its live
    scaled scores: ``(o (B, H, Sq, D), lse (B, H, Sq))``, both float32 (or
    float64).  A row with no live key has ``o = 0`` and ``lse = -inf``."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qf = _acc(q).reshape(b, kv, h // kv, sq, d)
    kf, vf = _acc(k)[:, :, None], _acc(v)[:, :, None]
    logits = torch.matmul(qf, kf.transpose(-1, -2)) / math.sqrt(d)
    mask = _mask(b, sq, sk, lengths, False, q.device)
    lse = torch.logsumexp(torch.where(mask, logits, -math.inf), dim=-1)
    top = torch.where(torch.isinf(lse), 0.0, lse)[..., None]
    p = torch.where(mask, torch.exp(logits - top), 0.0)
    o = torch.matmul(p, vf)
    return o.reshape(b, h, sq, d), lse.reshape(b, h, sq)


def mha_ref_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, do: torch.Tensor,
                lengths: torch.Tensor | None = None, causal: bool = True):
    """The gradient of :func:`mha_ref` at output gradient ``do``:
    ``(dq, dk, dv)`` in the inputs' types.  ``o`` is the forward's output
    (as the kernel saved it, so in its type).  The softmax gradient
    written out: ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P (dP - Delta)``
    with ``Delta = rowsum(dO * O)``, ``dQ = dS K / sqrt(D)``, ``dK = dS^T Q
    / sqrt(D)``; ``dK`` and ``dV`` sum over the G query heads of a KV
    head.  A masked pair has ``P = 0``, so a row with no live key gets
    zero gradients."""
    b, h, sq, d = q.shape
    kv = k.shape[1]
    g = h // kv
    qf = _acc(q).reshape(b, kv, g, sq, d)
    kf, vf = _acc(k)[:, :, None], _acc(v)[:, :, None]
    dof = _acc(do).reshape(b, kv, g, sq, d)
    of = _acc(o).reshape(b, kv, g, sq, d)
    p, _ = _probs(qf, kf, lengths, causal)
    delta = (dof * of).sum(-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(2)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) / math.sqrt(d)
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(2) / math.sqrt(d)
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
