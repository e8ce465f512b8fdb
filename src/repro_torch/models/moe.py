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

In a partitioned step (``DTensor`` activations, expert choice) the layer
is partitioned as the reference's GSPMD partitions it
(:func:`_moe_partitioned`): the routing stays global (every rank
all-gathers the (N, E) float32 gates and takes the same stable top-k), the
E x C expert rows are divided over every rank (C over the batch's mesh
dims, E or the expert FFN's width over ``model`` as the weights are
sharded, or C there too), and no rank holds a replica of the experts'
rows: a rank gathers its rows from the all-gathered tokens, adds its
weighted output rows into a buffer of the N tokens' places in expert
order, and the buffers' sum reaches each token's owner by a
reduce-scatter over the batch's mesh dims and an all-reduce over the
others.  The dispatch's gradient is the combine's collectives and the
combine's the dispatch's.  So across ranks a token's rows meet in the
collective's sum, in the collective's order; on one rank, and in every
unpartitioned step, the adds keep the expert order above.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.wavefront_matmul.ops import TILE_M, wavefront_matmul
from .common import ModelConfig, batch_only, dense_init, is_dtensor

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
    """The expert-ordered adds of ``ye`` (E, C, d) into (N, d)."""
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


class _Plan:
    """How a partitioned step divides one MoE layer over a mesh: the mesh
    dims of the tokens' shards (``tokens``), the dims the expert rows are
    divided on (``rows``: C; ``experts``: E; ``ff``: the expert FFN's
    width, each rank's output rows a partial sum), and this rank's block:
    experts ``[e0, e0 + e_loc)``, slots ``[c0, c0 + c_loc)`` of C padded to
    ``c_pad`` (a padded slot holds token index N, the place of none, and
    weight 0).  A dim of one rank makes no collective."""

    def __init__(self, mesh, tokens, weights, e, cap, n_loc):
        from torch.distributed.tensor import Shard
        self.mesh = mesh
        sizes, coord = mesh.shape, mesh.get_coordinate()
        self.tokens = [i for i in tokens if sizes[i] > 1]
        self.n = n_loc * math.prod(sizes[i] for i in self.tokens)
        self.experts = [i for i, p in enumerate(weights) if p == Shard(0)]
        self.ff = [i for i, p in enumerate(weights) if p == Shard(2)]
        self.rows = [i for i in range(mesh.ndim) if sizes[i] > 1
                     and i not in self.experts and i not in self.ff]
        # every rank holds a part of each token's output: the combine sums
        # over the tokens' dims by reduce-scatter, the others by all-reduce
        self.others = [i for i in range(mesh.ndim) if sizes[i] > 1
                       and i not in self.tokens]
        parts, e_parts, r, ei = 1, 1, 0, 0
        for i in range(mesh.ndim):
            if i in self.rows:
                parts, r = parts * sizes[i], r * sizes[i] + coord[i]
            if i in self.experts:
                e_parts, ei = e_parts * sizes[i], ei * sizes[i] + coord[i]
        if e % e_parts:
            raise ValueError(f"{e} experts do not divide over {e_parts} "
                             "ranks")
        self.e_loc = e // e_parts
        self.e0 = ei * self.e_loc
        # C split at whole 128-row tiles, or, where all of C fits one
        # tile, at any row (that tile's flag then holds for every shard)
        c_loc = -(-cap // parts)
        self.one_tile = parts * c_loc <= TILE_M
        if parts > 1 and not self.one_tile:
            c_loc = -(-c_loc // TILE_M) * TILE_M
        self.c_loc, self.c_pad, self.c0 = c_loc, parts * c_loc, r * c_loc

    def rows_of(self, t, topi):
        """The rows ``t[topi]`` (e_loc, c_loc, ...) of the N tokens' ``t``;
        a padded slot (index N) takes row N - 1, which its zero weight
        cancels."""
        return _gather(t, topi.clamp(max=self.n - 1))

    def adds(self, rows, topi):
        """``rows`` (e_loc, c_loc, ...) added in expert order into zeros
        of the N tokens' places (:func:`_add_rows`); a padded slot's row
        goes to a place of its own past the N, dropped."""
        out = rows.new_zeros((self.n + 1,) + rows.shape[2:])
        return _add_rows(out, topi, rows)[:self.n]

    def gather(self, t):
        """The tokens' rows of every rank, in the global order (the
        inner mesh dim first)."""
        import torch.distributed._functional_collectives as funcol
        gather = getattr(funcol, "all_gather_single", None) \
            or funcol.all_gather_tensor
        for i in reversed(self.tokens):
            t = funcol.wait_tensor(gather(t.contiguous(), 0, (self.mesh, i)))
        return t

    def reduce(self, t):
        """Every rank's (N, ...) partial sums summed, this rank's tokens'
        rows kept: a reduce-scatter over the tokens' dims (the outer
        first), then an all-reduce over the others."""
        import torch.distributed._functional_collectives as funcol
        scatter = getattr(funcol, "reduce_scatter_single", None) \
            or funcol.reduce_scatter_tensor
        for i in self.tokens:
            t = funcol.wait_tensor(scatter(t.contiguous(), "sum", 0,
                                           (self.mesh, i)))
        for i in self.others:
            t = funcol.wait_tensor(funcol.all_reduce(t, "sum",
                                                     (self.mesh, i)))
        return t


class _GatherAll(torch.autograd.Function):
    """This rank's tokens' rows -> every token's (:meth:`_Plan.gather`);
    the gradient sums every rank's (:meth:`_Plan.reduce`)."""

    @staticmethod
    def forward(ctx, t, plan):
        ctx.plan = plan
        return plan.gather(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.reduce(g), None


class _Dispatch(torch.autograd.Function):
    """This rank's expert rows ``flat[topi]`` (e_loc, c_loc, d) from its
    tokens ``flat`` (n_loc, d): the tokens all-gathered, then the rows
    taken.  Its gradient adds the rows' gradients into the N tokens'
    places in expert order and sums every rank's (the combine's
    collectives)."""

    @staticmethod
    def forward(ctx, flat, topi, plan):
        ctx.save_for_backward(topi)
        ctx.plan = plan
        return plan.rows_of(plan.gather(flat), topi)

    @staticmethod
    def backward(ctx, g):
        topi, = ctx.saved_tensors
        return ctx.plan.reduce(ctx.plan.adds(g, topi)), None, None


class _CombineRows(torch.autograd.Function):
    """This rank's weighted output rows ``ye`` (e_loc, c_loc, d) added in
    expert order into a buffer of the N tokens' places, every rank's
    buffer summed and this rank's tokens' rows kept (n_loc, d).  Its
    gradient is the dispatch's: the output gradient all-gathered, then
    the rows taken."""

    @staticmethod
    def forward(ctx, ye, topi, plan):
        ctx.save_for_backward(topi)
        ctx.plan = plan
        return plan.reduce(plan.adds(ye, topi))

    @staticmethod
    def backward(ctx, g):
        topi, = ctx.saved_tensors
        return ctx.plan.rows_of(ctx.plan.gather(g), topi), None, None


def _moe_partitioned(cfg: ModelConfig, p, x, capacity_factor: float):
    """:func:`moe_apply`'s expert choice on ``DTensor``s (the module
    docstring).  The expert FFN runs on ``DTensor``s of this rank's block
    (``xe`` rows sharded on C, and on E or with the FFN's width as the
    weights are), so ``wavefront_matmul``'s sharding rules place it with
    no collective; the routing, the dispatch and the combine run on local
    tensors, their collectives explicit."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from ..sharding.partition import from_local, redistributed
    x = batch_only(x)
    mesh = x.device_mesh
    b, s, d = x.shape
    n, e = b * s, cfg.num_experts
    flat = x.reshape(n, d)
    gates = torch.softmax((flat @ p["router"].to(flat.dtype)).float(), -1)
    tokens = [i for i, pl in enumerate(flat.placements) if pl == Shard(0)]
    w = {k: p[k].to(x.dtype) for k in ("w_in", "w_gate", "w_out")}
    keep = [pl if pl in (Shard(0), Shard(2)) else Replicate()
            for pl in w["w_in"].placements]
    w["w_in"] = redistributed(w["w_in"], keep)
    w["w_gate"] = redistributed(w["w_gate"], keep)
    w["w_out"] = redistributed(w["w_out"], [Shard(1) if pl == Shard(2)
                                            else pl for pl in keep])
    cap = max(1, int(round(n * cfg.top_k * capacity_factor / e)))
    flat_l = flat.to_local()
    plan = _Plan(mesh, tokens, keep, e, cap, flat_l.shape[0])
    if plan.n != n:
        raise ValueError(f"{n} tokens do not divide evenly over the batch's "
                         "ranks")

    gates_all = _GatherAll.apply(gates.to_local(), plan)        # (N, E)
    topv, topi = top_k(gates_all.T, cap)
    pad = (0, plan.c_pad - cap)
    blk = (slice(plan.e0, plan.e0 + plan.e_loc),
           slice(plan.c0, plan.c0 + plan.c_loc))
    topv_l, topi_l = F.pad(topv, pad)[blk], F.pad(topi, pad, value=n)[blk]
    tiles = -(-plan.c_loc // TILE_M)
    if plan.one_tile:
        live = torch.ones((tiles,), dtype=torch.bool, device=flat_l.device)
    else:
        slot = torch.arange(plan.c0, plan.c0 + tiles * TILE_M,
                            device=flat_l.device)
        live = (slot < cap).reshape(tiles, TILE_M).any(-1)
    active_l = live.to(torch.int32).expand(plan.e_loc, tiles).contiguous()

    xe_l = _Dispatch.apply(flat_l, topi_l, plan)          # (e_loc, c_loc, d)
    place = [Shard(0) if i in plan.experts else
             Shard(1) if i in plan.rows else Replicate()
             for i in range(mesh.ndim)]
    act_place = [Shard(0) if i in plan.experts else
                 Shard(1) if i in plan.rows and not plan.one_tile
                 else Replicate() for i in range(mesh.ndim)]
    xe = _FromLocal.apply(xe_l, mesh, place, (e, plan.c_pad, d))
    active = from_local(active_l, (mesh, act_place),
                        (e, -(-plan.c_pad // TILE_M)))
    ye = _expert_ffn(w, xe, x.dtype, active)
    out_place = [Partial() if i in plan.ff else pl
                 for i, pl in enumerate(place)]
    ye = redistributed(ye, out_place)
    ye_l = ye.to_local(grad_placements=place)
    ye_l = ye_l * topv_l[..., None].to(x.dtype)
    out_l = _CombineRows.apply(ye_l, topi_l, plan)        # (n_loc, d)
    out = from_local(out_l, (mesh, flat.placements), (n, d))
    return out.reshape(b, s, d)


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose gradient is the local shard of the
    output gradient as it is placed, a partial sum included (the
    dispatch's gradient sums every rank's anyway; ``from_local``'s own
    would all-reduce the rows first)."""

    @staticmethod
    def forward(ctx, t, mesh, place, shape):
        from ..sharding.partition import from_local
        ctx.place = place
        return from_local(t, (mesh, place), shape)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial
        from ..sharding.partition import redistributed
        want = [pl if isinstance(pl, Partial) else ctx.place[i]
                for i, pl in enumerate(g.placements)]
        return redistributed(g, want, local=True), None, None, None


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
    if is_dtensor(x) and mode == "expert_choice":
        return _moe_partitioned(cfg, p, x, capacity_factor)
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
