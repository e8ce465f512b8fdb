"""xLSTM blocks: mLSTM (matrix memory, parallel form over a sequence) and
sLSTM (scalar memory, a true recurrence), interleaved 7:1.

The port of ``repro/models/xlstm.py``.  A sequence runs the mLSTM in
its stabilised parallel form (the gate-decay matrix plays the causal
mask) and the sLSTM as a scan over time (``scan_util.maybe_scan``);
decode is the O(1) recurrence of each.  Prefill, as the reference's,
is the decode step scanned over the prompt.  The reference computes
all of it as ``jnp`` code, with no Pallas kernel, so plain PyTorch is
its port.  The parameter tree's ``blocks`` is a list of two kinds of
dict (the reference's heterogeneous Python list).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import transformer
from .scan_util import maybe_scan
from .common import (ModelConfig, batch_local, dense_init, embed,
                     embed_init, full_like_batch, gather_fsdp, merge_dims,
                     rms_norm, silu, softmax_cross_entropy, split_dim)


def _is_slstm(cfg: ModelConfig, i: int) -> bool:
    return i % 8 == 7            # 7:1 mLSTM:sLSTM


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def mlstm_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    d = cfg.d_model
    inner = 2 * d                 # proj_factor 2
    pd = cfg.param_dtype
    w = lambda shape: dense_init(gen, shape, 0, pd, device)
    return {"ln": torch.ones((d,), dtype=pd, device=device),
            "w_up": w((d, 2 * inner)), "w_q": w((inner, inner)),
            "w_k": w((inner, inner)), "w_v": w((inner, inner)),
            "w_i": w((inner, cfg.n_heads)), "w_f": w((inner, cfg.n_heads)),
            "w_down": w((inner, d))}


def mlstm_specs() -> dict:
    """Logical sharding specs of :func:`mlstm_params`."""
    return {"ln": (None,), "w_up": ("fsdp", "ff"), "w_q": ("ff", "heads2"),
            "w_k": ("ff", "heads2"), "w_v": ("ff", "heads2"),
            "w_i": ("ff", None), "w_f": ("ff", None),
            "w_down": ("ff", "fsdp")}


def _mlstm_qkvgates(cfg: ModelConfig, p, xm):
    b, s, inner = xm.shape
    h = cfg.n_heads
    pd = inner // h
    q = split_dim(xm @ p["w_q"].to(xm.dtype), -1, h, pd)
    k = split_dim(xm @ p["w_k"].to(xm.dtype), -1, h, pd)
    v = split_dim(xm @ p["w_v"].to(xm.dtype), -1, h, pd)
    logi = (xm @ p["w_i"].to(xm.dtype)).float()
    logf = F.logsigmoid((xm @ p["w_f"].to(xm.dtype)).float() + 1.0)
    return q, k, v, logi, logf, pd


def _mlstm_parallel(pd: int, q, k, v, logi, logf):
    """The parallel form's (B, T, H, P) output, before its gate."""
    # D[t,s] = exp(F[t] - F[s] + logi[s] - m[t]),  F = cumsum(logf)
    f_cum = torch.cumsum(logf, dim=1)                       # (B,S,H)
    src = logi - f_cum
    m = f_cum + torch.cummax(src, dim=1).values             # stabiliser
    dmat = f_cum[:, :, None, :] - f_cum[:, None, :, :] \
        + logi[:, None, :, :] - m[:, :, None, :]            # (B,T,S,H)
    s_len = q.shape[1]
    causal = torch.tril(torch.ones((s_len, s_len), dtype=torch.bool,
                                   device=q.device))
    dexp = torch.exp(torch.where(causal[None, :, :, None], dmat,
                                 float("-inf")))
    att = torch.einsum("bthp,bshp->btsh", q.float(), k.float()) \
        / math.sqrt(pd)
    w = att * dexp
    norm = torch.maximum(torch.abs(w.sum(dim=2)), torch.exp(-m))  # (B,T,H)
    y = torch.einsum("btsh,bshp->bthp", w, v.float())
    return y / norm[..., None]


def mlstm_apply(cfg: ModelConfig, p, x):
    """Parallel form.  x: (B, S, d).  In a partitioned step the parallel
    form is batch-parallel, on each rank's batch rows
    (``common.batch_local``)."""
    p = gather_fsdp(p)
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    xm, z = torch.chunk(h_in @ p["w_up"].to(x.dtype), 2, dim=-1)
    q, k, v, logi, logf, pd = _mlstm_qkvgates(cfg, p, xm)
    y = batch_local(functools.partial(_mlstm_parallel, pd), q, k, v, logi,
                    logf)
    y = merge_dims(y.to(x.dtype), -2)
    return x + (y * silu(z)) @ p["w_down"].to(x.dtype)


def _full(shape, fill, device, like):
    if like is not None:
        return full_like_batch(like, shape, fill, torch.float32)
    return torch.full(shape, fill, dtype=torch.float32, device=device)


def mlstm_state(cfg: ModelConfig, batch: int, device=None,
                like=None) -> dict:
    """Zeros (``m``: -1e30); with ``like`` (the batch's tokens), placed
    by its batch (``common.full_like_batch``)."""
    h, inner = cfg.n_heads, 2 * cfg.d_model
    pd = inner // h
    return {"c": _full((batch, h, pd, pd), 0.0, device, like),
            "n": _full((batch, h, pd), 0.0, device, like),
            "m": _full((batch, h), -1e30, device, like)}


def mlstm_decode(cfg: ModelConfig, p, x, st):
    """x: (B, d); st: the layer's state.  Returns (x + out, new state)."""
    p = gather_fsdp(p)
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    xm, z = torch.chunk(h_in @ p["w_up"].to(x.dtype), 2, dim=-1)
    q, k, v, logi, logf, pd = _mlstm_qkvgates(cfg, p, xm[:, None, :])
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                     # (B,H,P)
    logi, logf = logi[:, 0], logf[:, 0]                     # (B,H)
    m_new = torch.maximum(logf + st["m"], logi)
    f_ = torch.exp(logf + st["m"] - m_new)
    i_ = torch.exp(logi - m_new)
    kf = k.float() / math.sqrt(pd)
    c = st["c"] * f_[..., None, None] + \
        i_[..., None, None] * (v.float()[..., :, None] * kf[..., None, :])
    n = st["n"] * f_[..., None] + i_[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhpq,bhq->bhp", c, qf)
    den = torch.maximum(torch.abs(torch.einsum("bhq,bhq->bh", n, qf)),
                        torch.exp(-m_new))
    y = (num / den[..., None]).to(x.dtype).reshape(x.shape[0], -1)
    return x + (y * silu(z)) @ p["w_down"].to(x.dtype), \
        {"c": c, "n": n, "m": m_new}


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

GATES = ("i", "f", "z", "o")


def slstm_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    d, pd = cfg.d_model, cfg.param_dtype
    gates = {}
    # the reference draws w_i, w_f, w_z, w_o, then r_i .. r_o (x 0.1)
    for g in GATES:
        gates[f"w_{g}"] = dense_init(gen, (d, d), 0, pd, device)
    for g in GATES:
        gates[f"r_{g}"] = dense_init(gen, (d, d), 0, pd, device) * 0.1
    return {"ln": torch.ones((d,), dtype=pd, device=device), **gates,
            "w_down": dense_init(gen, (d, d), 0, pd, device)}


def slstm_specs() -> dict:
    """Logical sharding specs of :func:`slstm_params`."""
    specs = {f"{w}_{g}": ("fsdp", "ff") for w in "wr" for g in GATES}
    specs.update({"ln": (None,), "w_down": ("ff", "fsdp")})
    return specs


def slstm_state(cfg: ModelConfig, batch: int, device=None,
                like=None) -> dict:
    z = lambda v: _full((batch, cfg.d_model), v, device, like)
    return {"c": z(0.0), "n": z(1e-6), "h": z(0.0), "m": z(-1e30)}


def _slstm_cell(p, xg, st):
    """xg: the gates' (B, d) pre-activations from x; st: the state."""
    h = st["h"]
    rec = lambda g: xg[g] + h @ p[f"r_{g}"].float()
    it, ft = rec("i"), rec("f")
    zt = torch.tanh(rec("z"))
    ot = torch.sigmoid(rec("o"))
    m_new = torch.maximum(ft + st["m"], it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + st["m"] - m_new)
    c = f_ * st["c"] + i_ * zt
    n = f_ * st["n"] + i_
    return {"c": c, "n": n, "h": ot * c / torch.clamp(n, min=1e-6),
            "m": m_new}


def _slstm_pre(cfg: ModelConfig, p, x):
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    return {g: (h_in @ p[f"w_{g}"].to(x.dtype)).float() for g in GATES}


def slstm_apply(cfg: ModelConfig, p, x):
    """x: (B, S, d): the recurrence over S."""
    p = gather_fsdp(p)
    pre = _slstm_pre(cfg, p, x)

    def body(st, xs):
        st2 = _slstm_cell(p, xs, st)
        return st2, st2["h"]

    _, hs = maybe_scan(body, slstm_state(cfg, x.shape[0], x.device),
                       {g: a.transpose(0, 1) for g, a in pre.items()})
    y = hs.transpose(0, 1).to(x.dtype)
    return x + y @ p["w_down"].to(x.dtype)


def slstm_decode(cfg: ModelConfig, p, x, st):
    p = gather_fsdp(p)
    st2 = _slstm_cell(p, _slstm_pre(cfg, p, x), st)
    return x + st2["h"].to(x.dtype) @ p["w_down"].to(x.dtype), st2


# --------------------------------------------------------------------------
# Full model
# --------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, device=None, *,
                dtype=None) -> dict:
    """The reference's leaves; with ``dtype``, each drawn part cast to it
    at once."""
    keep = (lambda t: t) if dtype is None \
        else (lambda t: transformer.cast(t, dtype))
    pd = cfg.param_dtype
    return {
        "embed": keep(embed_init(gen, (cfg.vocab, cfg.d_model), pd, device)),
        "blocks": [keep((slstm_params if _is_slstm(cfg, i) else mlstm_params)
                        (gen, cfg, device)) for i in range(cfg.n_layers)],
        "ln_f": keep(torch.ones((cfg.d_model,), dtype=pd, device=device)),
        "unembed": keep(embed_init(gen, (cfg.d_model, cfg.vocab), pd,
                                   device)),
    }


def param_specs(cfg: ModelConfig) -> dict:
    blocks = [slstm_specs() if _is_slstm(cfg, i) else mlstm_specs()
              for i in range(cfg.n_layers)]
    return {"embed": ("vocab", "fsdp"), "blocks": blocks, "ln_f": (None,),
            "unembed": ("fsdp", "vocab")}


def forward(cfg: ModelConfig, params, tokens):
    """tokens: (B, S).  Returns logits (B, S, V)."""
    x = embed(cfg, params, tokens)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, bp in enumerate(params["blocks"]):
        fn = slstm_apply if _is_slstm(cfg, i) else mlstm_apply
        x = checkpoint(fn, cfg, bp, x, use_reentrant=False) if remat \
            else fn(cfg, bp, x)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return transformer.unembed(cfg, params, x)


def loss_fn(cfg: ModelConfig, params, tokens, mask=None):
    tokens = tokens.long()
    logits = forward(cfg, params, tokens[:, :-1])
    m = mask[:, 1:] if mask is not None else None
    return softmax_cross_entropy(logits, tokens[:, 1:], m)


def init_cache(cfg: ModelConfig, batch: int, device=None,
               like=None) -> list:
    return [slstm_state(cfg, batch, device, like) if _is_slstm(cfg, i)
            else mlstm_state(cfg, batch, device, like)
            for i in range(cfg.n_layers)]


def cache_specs(cfg: ModelConfig) -> list:
    return [{k: ("batch", None) for k in ("c", "n", "h", "m")}
            if _is_slstm(cfg, i) else
            {"c": ("batch", None, None, None), "n": ("batch", None, None),
             "m": ("batch", None)}
            for i in range(cfg.n_layers)]


def prefill(cfg: ModelConfig, params, tokens):
    """The decode step scanned over the prompt (O(S) time, O(1) state).
    Returns (the last step's logits (B, V), cache, lengths (B,)); the
    carry holds the last step's logits alone."""
    b = tokens.shape[0]

    def body(carry, token):
        _, cache, lengths = carry
        return decode_step(cfg, params, cache, token, lengths), None

    # the first carry is built in the call, so that nothing here holds
    # the first cache once the scan has stepped past it
    return maybe_scan(body, (None, init_cache(cfg, b, like=tokens),
                             torch.zeros((b,), dtype=torch.int32,
                                         device=tokens.device)),
                      tokens.transpose(0, 1))[0]


def decode_step(cfg: ModelConfig, params, cache, token, lengths):
    """One decode step.  Returns (logits (B, V), the new cache (a list of
    new state dicts), lengths + 1)."""
    x = embed(cfg, params, token)
    new = []
    for i, bp in enumerate(params["blocks"]):
        fn = slstm_decode if _is_slstm(cfg, i) else mlstm_decode
        x, st = fn(cfg, bp, x, cache[i])
        new.append(st)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return transformer.unembed(cfg, params, x), new, lengths + 1
