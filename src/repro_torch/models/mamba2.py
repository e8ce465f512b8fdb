"""Mamba2 (SSD) blocks: the chunked parallel scan for a whole sequence, an
O(1) recurrent state for decode.

The port of ``repro/models/mamba2.py``.  The minimal SSD recurrence
(Dao & Gu, 2024), per head with state size N:

    h_t = exp(a_t) * h_{t-1} + B_t x_t^T
    y_t = C_t h_t + D x_t

over a sequence: the intra-chunk quadratic term plus the scan of the
chunk-final states (a Python loop over the chunks for the reference's
``lax.scan``).  The reference computes all of it as ``jnp`` code, with
no Pallas kernel, so plain PyTorch is its port; the gates and the
state are float32, as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init, silu

#: tokens a chunk of the parallel scan; a sequence that it does not
#: divide is one chunk (the reference's rule)
CHUNK = 256


def ssd_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    d, h, p_dim, n = cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, \
        cfg.ssm_state
    inner = h * p_dim
    pd = cfg.param_dtype
    return {
        # fused input projection: [x (inner), z (inner), B (h*n), C (h*n),
        # dt (h)]
        "w_in": dense_init(gen, (d, 2 * inner + 2 * h * n + h), 0, pd,
                           device),
        "w_out": dense_init(gen, (inner, d), 0, pd, device),
        "a_log": torch.zeros((h,), dtype=pd, device=device),  # A = -exp
        "d_skip": torch.ones((h,), dtype=pd, device=device),
        "dt_bias": torch.zeros((h,), dtype=pd, device=device),
        "ln": torch.ones((d,), dtype=pd, device=device),
    }


def ssd_specs() -> dict:
    """Logical sharding specs of :func:`ssd_params`."""
    return {"w_in": ("fsdp", "ff"), "w_out": ("ff", "fsdp"),
            "a_log": (None,), "d_skip": (None,), "dt_bias": (None,),
            "ln": (None,)}


def _split_proj(cfg: ModelConfig, proj):
    h, p_dim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    inner = h * p_dim
    return torch.split(proj, [inner, inner, h * n, h * n, h], dim=-1)


def _segsum(a):
    """a: (..., T) -> (..., T, T) lower-triangular cumulative sums:
    out[i, j] = sum(a[j+1..i]) for j <= i, -inf above the diagonal."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, float("-inf"))


def _gates(cfg: ModelConfig, p, dt):
    """(dt, log-decay a): float32, (..., H) each."""
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["a_log"].float()) * dt


def ssd_apply(cfg: ModelConfig, p, u, return_state=False):
    """u: (B, S, d) -> (B, S, d); with ``return_state`` also the final
    state (B, H, N, P), float32.  Chunks of :data:`CHUNK` tokens where
    that divides S, else one chunk."""
    b, s, _ = u.shape
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    proj = u @ p["w_in"].to(u.dtype)
    x, z, bm, cm, dt = _split_proj(cfg, proj)
    x = x.reshape(b, s, h, pd)
    bm = bm.reshape(b, s, h, n).float()
    cm = cm.reshape(b, s, h, n).float()
    dt, a = _gates(cfg, p, dt)                                  # (B, S, H)
    xdt = x.float() * dt[..., None]

    cl = CHUNK if s % CHUNK == 0 else s      # small sequences: one chunk
    nc = s // cl
    ar = a.reshape(b, nc, cl, h).permute(0, 3, 1, 2)            # (B,H,NC,CL)
    xr = xdt.reshape(b, nc, cl, h, pd)
    br = bm.reshape(b, nc, cl, h, n)
    cr = cm.reshape(b, nc, cl, h, n)

    # 1. intra-chunk (quadratic within the chunk)
    ls = torch.exp(_segsum(ar))                          # (B,H,NC,CL,CL)
    att = torch.einsum("bclhn,bcshn->bhcls", cr, br)
    y_diag = torch.einsum("bhcls,bhcls,bcshp->bclhp", att, ls, xr)

    # 2. chunk-final states
    a_cum = torch.cumsum(ar, dim=-1)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)           # (B,H,NC,CL)
    states = torch.einsum("bclhn,bhcl,bclhp->bchnp", br, decay_states, xr)

    # 3. inter-chunk recurrence over the chunk states
    chunk_decay = torch.exp(a_cum[..., -1])                     # (B,H,NC)
    carry = torch.zeros((b, h, n, pd), dtype=torch.float32, device=u.device)
    prev = []
    for c in range(nc):
        prev.append(carry)                   # the state before chunk c
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)                          # (B,NC,H,N,P)

    # 4. inter-chunk output contribution
    state_decay = torch.exp(a_cum)                              # (B,H,NC,CL)
    y_off = torch.einsum("bclhn,bhcl,bchnp->bclhp", cr, state_decay,
                         prev_states)

    y = (y_diag + y_off).reshape(b, s, h, pd)
    y = y + xdt * p["d_skip"].float()[None, None, :, None]
    y = y.to(u.dtype).reshape(b, s, h * pd) * silu(z)
    out = y @ p["w_out"].to(u.dtype)
    if return_state:
        return out, carry
    return out


# --------------------------------------------------------------------------
# Decode: recurrent state
# --------------------------------------------------------------------------

def init_ssd_state(cfg: ModelConfig, batch: int, n_layers: int,
                   device=None) -> torch.Tensor:
    return torch.zeros((n_layers, batch, cfg.ssm_heads, cfg.ssm_state,
                        cfg.ssm_head_dim), dtype=torch.float32, device=device)


def ssd_state_spec() -> tuple:
    return (None, "batch", None, None, None)


def ssd_decode(cfg: ModelConfig, p, u, state):
    """u: (B, d); state: (B, H, N, P) -> (y (B, d), new state)."""
    b, _ = u.shape
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    proj = u @ p["w_in"].to(u.dtype)
    x, z, bm, cm, dt = _split_proj(cfg, proj)
    x = x.reshape(b, h, pd).float()
    bm = bm.reshape(b, h, n).float()
    cm = cm.reshape(b, h, n).float()
    dt, a = _gates(cfg, p, dt)                                  # (B, H)
    xdt = x * dt[..., None]
    new_state = state * torch.exp(a)[..., None, None] + \
        bm[..., :, None] * xdt[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", cm, new_state)
    y = y + xdt * p["d_skip"].float()[None, :, None]
    y = y.reshape(b, h * pd).to(u.dtype) * silu(z)
    return y @ p["w_out"].to(u.dtype), new_state
