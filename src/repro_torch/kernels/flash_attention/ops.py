"""Public wrapper of flash attention with KV-tile skipping: a CUDA kernel
for a CUDA tensor, the plain version (:mod:`.ref`) for a CPU (or
``meta``) tensor.

Two hand-written kernels in ``csrc/flash_attention.cu``, three routes;
:func:`route` picks one by an explicit rule, and a CUDA tensor always
launches the routed kernel or raises:

* ``"wgmma"``: bfloat16, ``head_dim`` a multiple of 16 up to 128, more
  than :data:`DECODE_ROWS` query rows per KV head (prefill), TMA-legal
  q, k and v; TMA and ``wgmma`` on the tensor cores;
* ``"split"``: decode's rows (at most :data:`DECODE_ROWS` per KV head)
  over a cache of more than :data:`SPLIT_TILES` 64-key tiles: the
  ``simt`` kernel with the live KV prefix split over blocks of
  :data:`SPLIT_TILES` tiles, the partial results combined in a fixed
  order inside the same launch;
* ``"simt"``: everything else (float32, other head dims, short caches):
  the CUDA cores in float32.

:func:`flash_attention_partial` is decode's attention (no causal mask, at
most :data:`DECODE_ROWS` query rows per KV head) on the ``split`` or
``simt`` route of the same kernel, its output in float32 with each row's
log-sum-exp beside it (``lm_flash_attention`` given an ``lse``
pointer; ``run_route(..., partial=True)``): the partial result
of attention over one range of keys, which :func:`merge_partials` merges
across ranges exactly as the ``split`` route merges its blocks.  Where
:func:`flash_attention` is given a decode-shaped, non-causal call on
``DTensor`` keys and values sharded on their positions (a KV cache
sharded on ``seq``) and no gradient is wanted (the partial output has
none), each rank attends over its own keys and the ranks merge by
all-reduces of the row maxima and of the weighted sums
(:func:`_over_key_shards`); the cache is never gathered.

The gradient (``csrc/flash_attention_bwd.cu``) runs through
:func:`attention_bwd`: two kernels, ``dq`` a query tile and ``dkdv`` a
key tile, on one of two routes that :func:`route_bwd` picks by an
explicit rule (``run_bwd_route`` names one):

* ``"wgmma"``: bfloat16, ``head_dim`` a multiple of 16 up to
  :data:`BWD_WGMMA_HEAD_DIM`, TMA-legal q, k, v, o and do; TMA and
  ``wgmma`` on the tensor cores;
* ``"simt"``: everything else (float32, other head dims, operands TMA
  cannot read): the CUDA cores in float32.

:func:`flash_attention` and its gradient are the operators
``torch.ops.repro_torch.flash_attention`` and ``.flash_attention_bwd``
(``torch.library.custom_op``), each with a fake implementation that
allocates what the CUDA route allocates (the outputs; the backward's
log-sum-exp and Delta and the ``split`` route's partials are the
workspace :func:`workspace_bytes` names), a FLOP formula
(``torch.utils.flop_counter``: the products of the plain versions'
matmuls), and, once :func:`register_dtensor_rules` has run, a
``DTensor`` sharding rule (q, k, v and the output alike on batch or
heads, ``lengths`` on batch or replicated).  The backward is recorded
only when a gradient is wanted (grad mode on and an operand that
requires one), so a run under ``no_grad`` (the serve) launches what it
launched before.  On a CPU tensor the backward is :func:`.ref.
mha_ref_bwd`; on a ``meta`` tensor each operator takes its fake
implementation and launches nothing.
"""
from __future__ import annotations

import math

import torch

from .. import build
from .ref import mha_ref, mha_ref_bwd, mha_ref_lse

DTYPES = (torch.float32, torch.bfloat16)
#: the kernel against its plain version, ``|got - plain| <= atol + rtol *
#: |plain|``: both accumulate in float32, in other orders; a bfloat16
#: output may then round to the neighbouring value, one bf16 ulp, which
#: is at most 2^-7 of it
TOLERANCE = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -7)}
MAX_HEAD_DIM = 128
#: the backward kernels against :func:`.ref.mha_ref_bwd` (the same
#: softmax gradient, float32 sums in other orders), per gradient: float32,
#: whose gradients sum hundreds of products of O(1) terms with
#: cancellation in ``dP - Delta``, within ``atol`` of the terms' scale;
#: bfloat16, one bf16 ulp (2^-7 of the value) beyond that
BWD_TOLERANCE = {torch.float32: (1e-4, 1e-4),
                 torch.bfloat16: (1e-4, 2.0 ** -7)}
ROUTES = ("wgmma", "split", "simt")
#: the routes of :func:`flash_attention_partial`: decode's
PARTIAL_ROUTES = ("split", "simt")
#: the backward's routes, and its two kernels (each launch counted by
#: kernel and route, apart from the forward's)
BWD_ROUTES = ("wgmma", "simt")
BWD_KERNELS = ("dq", "dkdv")
#: the widest head_dim the backward's ``wgmma`` kernels take
BWD_WGMMA_HEAD_DIM = 128
#: query rows of one KV head (grouped heads x positions) up to which the
#: rows are decode's, and ``split`` or ``simt`` takes them
DECODE_ROWS = 16
#: 64-key tiles a block of the ``split`` route takes
SPLIT_TILES = 2
_KEYS_PER_TILE = 64
#: (device, stream) -> int32 arrival counters of the ``split`` route;
#: each launch's last block sets its counter back to 0
_COUNTERS: dict = {}


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route that computes the attention: ``"wgmma"``, ``"split"``
    or ``"simt"`` (see the module docstring).  A pure function of the operands' type,
    shape, layout and alignment."""
    b, h, sq, d = q.shape
    rows = h // max(1, k.shape[1]) * sq
    if rows <= DECODE_ROWS:
        tiles = -(-k.shape[2] // _KEYS_PER_TILE)
        return "split" if tiles > SPLIT_TILES else "simt"
    if q.dtype == torch.bfloat16 and d % 16 == 0 and d <= MAX_HEAD_DIM \
            and sq > 1 and build.tma_legal(q, k, v):
        return "wgmma"
    return "simt"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor | None = None,
                    causal: bool = True) -> torch.Tensor:
    """Online-softmax attention, output in ``q.dtype``.

    q: ``(B, H, Sq, D)``; k, v: ``(B, KV, Sk, D)`` with ``H % KV == 0``
    (query head ``h`` reads key/value head ``h // (H // KV)``); lengths:
    ``(B,)`` valid key count per batch entry (``None``: all ``Sk``).  A
    query at row ``i`` sees keys ``< lengths[b]`` and, when ``causal``,
    ``<= i + (Sk - Sq)``.  Any ``Sq``, ``Sk`` and ``D <= 128``.
    Differentiable in q, k and v (:func:`attention_bwd`).
    """
    if not causal and _decode_rows(q, k) and _keys_sharded(k) \
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (q, k, v))):
        return _over_key_shards(q, k, v, lengths)
    lengths = _check(q, k, v, lengths)
    return _attention_op(q, k, v, lengths, causal)


def _decode_rows(q, k) -> bool:
    """Whether the call has decode's rows: at most :data:`DECODE_ROWS`
    query rows (grouped heads x positions) per KV head."""
    return q.shape[1] // max(1, k.shape[1]) * q.shape[2] <= DECODE_ROWS


def flash_attention_partial(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            lengths: torch.Tensor | None = None):
    """Decode's non-causal attention over the keys at hand, and each row's
    log-sum-exp: ``(o, lse)``, ``o`` (B, H, Sq, D) normalised and ``lse``
    (B, H, Sq) ``m + log(l)`` of the online softmax, both float32.  A row
    with no live key gives ``o = 0`` and ``lse = -inf``.  Operands as
    :func:`flash_attention`'s, with at most :data:`DECODE_ROWS` query rows
    per KV head; a CUDA tensor launches the ``split`` or ``simt`` route
    (:func:`route`) or raises, a CPU one runs :func:`.ref.mha_ref_lse`.
    Not differentiable."""
    lengths = _check(q, k, v, lengths)
    if not _decode_rows(q, k):
        raise ValueError(f"flash_attention_partial takes at most "
                         f"{DECODE_ROWS} query rows per KV head")
    return _partial_op(q, k, v, lengths)


@torch.library.custom_op("repro_torch::flash_attention_partial",
                         mutates_args=())
def _partial_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if build.plain(q):
        o, lse = mha_ref_lse(q, k, v, lengths)
        return o.float(), lse.float()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return run_route(route(q, k, v), q, k, v, lengths, False, partial=True)


@_partial_op.register_fake
def _(q, k, v, lengths):
    return (q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty(q.shape[:-1], dtype=torch.float32))


def merge_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The attention over every key range from its ranges' partial
    results, stacked on a leading axis: ``o`` (R, ..., D) and ``lse`` (R,
    ...) of :func:`flash_attention_partial`; float32, ``sum_r exp(lse_r -
    M) o_r / sum_r exp(lse_r - M)`` with ``M = max_r lse_r``.  One range
    is returned as it is; a row with no live key in any range is 0."""
    return _merge(o, lse, lambda x, op: x.amax(0) if op == "max"
                  else x.sum(0))


def _merge(o, lse, total):
    """:func:`merge_partials` with ``total(x, op)`` reducing ``x`` over
    the key ranges by ``op``, ``"max"`` or ``"sum"``."""
    top = total(lse, "max")
    w = torch.exp(lse - torch.where(torch.isinf(top), 0.0, top))
    return total(w[..., None] * o, "sum") / total(w, "sum").clamp_min(
        1e-30)[..., None]


def _keys_sharded(k) -> bool:
    """Whether ``k`` is a ``DTensor`` sharded on its positions (dim 2),
    its other mesh dims on the batch, the heads or replicated."""
    import sys
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None or not isinstance(k, mod.DTensor):
        return False
    ok = (mod.Shard(0), mod.Shard(1), mod.Shard(2), mod.Replicate())
    return mod.Shard(2) in k.placements and all(p in ok for p in k.placements)


def _over_key_shards(q, k, v, lengths):
    """:func:`flash_attention` (non-causal, decode's rows) on ``DTensor``
    k and v sharded on their positions: q and ``lengths`` placed as k's
    batch and heads and replicated over the key shards' mesh dims (a
    collective only where they are placed otherwise); each rank runs
    :func:`flash_attention_partial` on its own keys, with the live keys
    of its range, ``clamp(lengths - offset, 0, T_local)``; the ranks
    merge as :func:`merge_partials` does, by all-reduces over those mesh
    dims of the row maxima (B, H, Sq), then of the weighted sums (B, H,
    Sq, D) and the weights (B, H, Sq), in float32; the result is cast to
    q's type once, after the merge.  A mesh dim of one rank makes no
    collective, so on a one-rank mesh the result is the kernel's own,
    bit for bit.  The shards may be uneven (``DTensor`` splits as
    ``torch.chunk`` does): a rank's first key is its shard's own global
    offset."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from ...sharding.partition import from_local, redistributed
    mesh = k.device_mesh
    seq = [i for i, p in enumerate(k.placements)
           if p == Shard(2) and mesh.shape[i] > 1]
    want = [Replicate() if p == Shard(2) else p for p in k.placements]

    def placed(t, place):
        if not isinstance(t, DTensor):
            t = from_local(t, (mesh, [Replicate()] * mesh.ndim), t.shape)
        return redistributed(t, place, local=True)

    if lengths is None:
        lengths = torch.full((q.shape[0],), k.shape[2], dtype=torch.int32,
                             device=k.to_local().device)
    q_l = placed(q, want)
    v_l = placed(v, k.placements)
    len_l = placed(lengths, [Shard(0) if p == Shard(0) else Replicate()
                             for p in want])
    k_l = k.to_local()
    first = compute_local_shape_and_global_offset(k.shape, mesh,
                                                  k.placements)[1][2]
    t = k_l.shape[2]
    live = (len_l.long() - first).clamp(0, t).to(torch.int32)
    o, lse = flash_attention_partial(q_l, k_l, v_l, live)

    def summed(x, op):
        for i in seq:
            x = funcol.wait_tensor(funcol.all_reduce(x, op, (mesh, i)))
        return x

    out = _merge(o, lse, summed)
    return from_local(out.to(q.dtype), (mesh, want), tuple(q.shape))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor, causal: bool) -> torch.Tensor:
    if build.plain(q):
        return mha_ref(q, k, v, lengths, causal).to(q.dtype)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return run_route(route(q, k, v), q, k, v, lengths, causal)


@_attention_op.register_fake
def _(q, k, v, lengths, causal):
    return q.new_empty(q.shape)


def _setup(ctx, inputs, output):
    q, k, v, lengths, causal = inputs
    ctx.save_for_backward(q, k, v, output, lengths)
    ctx.causal = causal


def _backward(ctx, do):
    q, k, v, out, lengths = ctx.saved_tensors
    dq, dk, dv = _attention_bwd_op(q, k, v, out, do, lengths, ctx.causal)
    return dq, dk, dv, None, None


_attention_op.register_autograd(_backward, setup_context=_setup)


def route_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, do: torch.Tensor) -> str:
    """The route that computes the attention's gradient: ``"wgmma"`` or
    ``"simt"`` (see the module docstring).  A pure function of the
    operands' type, shape, layout and alignment."""
    d = q.shape[-1]
    if all(t.dtype == torch.bfloat16 for t in (q, k, v, o, do)) \
            and d % 16 == 0 and 0 < d <= BWD_WGMMA_HEAD_DIM \
            and build.tma_legal(q, k, v, o, do):
        return "wgmma"
    return "simt"


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor,
                  lengths: torch.Tensor | None = None,
                  causal: bool = True):
    """``(dq, dk, dv)`` of :func:`flash_attention` at output gradient
    ``do``, given the forward's output ``o``; each in its input's type.
    A CPU or ``meta`` tensor takes :func:`.ref.mha_ref_bwd`; a CUDA tensor launches
    the two kernels of :func:`route_bwd`'s route or raises."""
    lengths = _check_bwd(q, k, v, o, do, lengths)
    return _attention_bwd_op(q, k, v, o, do, lengths, causal)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor,
                      lengths: torch.Tensor, causal: bool
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if build.plain(q):
        return mha_ref_bwd(q, k, v, o, do, lengths, causal)
    q, k, v, o = (t.contiguous() for t in (q, k, v, o))
    do = do.to(q.dtype).contiguous()
    return run_bwd_route(route_bwd(q, k, v, o, do), q, k, v, o, do, lengths,
                         causal)


@_attention_bwd_op.register_fake
def _(q, k, v, o, do, lengths, causal):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def workspace_bytes(op, q: torch.Tensor, k: torch.Tensor) -> int:
    """Bytes the CUDA route of ``op`` (the forward or backward operator)
    allocates for itself and frees before it returns, for q ``(B, H, Sq,
    D)`` and k ``(B, KV, Sk, D)`` of any device (``meta`` included): the
    backward's float32 log-sum-exp and Delta (each row padded to whole
    64-row tiles, as the ``wgmma`` route pads them), and the forward's
    ``split`` partials where decode's rows take that route."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if op is torch.ops.repro_torch.flash_attention_bwd.default:
        return 2 * b * h * (-(-sq // _KEYS_PER_TILE) * _KEYS_PER_TILE) * 4
    tiles = -(-sk // _KEYS_PER_TILE)
    if h // kv * sq <= DECODE_ROWS and tiles > SPLIT_TILES:
        splits = -(-tiles // SPLIT_TILES)
        return b * kv * splits * DECODE_ROWS * (d + 2) * 4
    return 0


def _flops(q_shape, k_shape, products: int) -> int:
    b, h, sq, d = q_shape
    return 2 * products * b * h * sq * k_shape[2] * d


def _register_flops() -> None:
    """The FLOP formulas: the plain versions' products, counted as
    ``FlopCounterMode`` counts their matmuls (2 a multiply-add): the
    forward's ``Q K^T`` and ``P V``; the backward's ``Q K^T`` again,
    ``P^T dO``, ``dO V^T``, ``dS K`` and ``dS^T Q``."""
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _(q, k, v, lengths, causal, *, out_shape=None, **kwargs):
        return _flops(q, k, 2)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
    def _(q, k, v, o, do, lengths, causal, *, out_shape=None, **kwargs):
        return _flops(q, k, 5)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_partial)
    def _(q, k, v, lengths, *, out_shape=None, **kwargs):
        return _flops(q, k, 2)


_register_flops()


def register_dtensor_rules() -> None:
    """Register the three operators' ``DTensor`` sharding rules
    (idempotent; :func:`flash_attention_partial`'s like the forward's, its
    ``lse`` placed as its output).
    On each mesh dim q, k, v, o, do and the outputs are sharded alike on
    the batch (``lengths`` with them) or on the heads (``lengths``
    replicated; only where the mesh dim divides both H and KV, so each
    shard keeps whole groups of query heads with their KV head), or all
    replicated; DTensor redistributes any other placement to one of
    these, and counts it."""
    if _RULES:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    def options(q, k, n_in, n_out):
        r, s0, s1 = Replicate(), Shard(0), Shard(1)
        out = [([r] * n_out, [r] * (n_in + 1) + [None])]
        out.append(([s0] * n_out, [s0] * (n_in + 1) + [None]))
        h, kv = q.shape[1], k.shape[1]
        if all(h % n == 0 and kv % n == 0 for n in q.mesh.shape):
            out.append(([s1] * n_out, [s1] * n_in + [r, None]))
        return out

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _(q, k, v, lengths, causal):
        return options(q, k, 3, 1)

    @register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
    def _(q, k, v, o, do, lengths, causal):
        return options(q, k, 5, 3)

    @register_sharding(torch.ops.repro_torch.flash_attention_partial.default)
    def _(q, k, v, lengths):
        return [(outs, ins[:-1]) for outs, ins in options(q, k, 3, 2)]

    _RULES.append(True)


_RULES: list = []


def run_bwd_route(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
                  lengths: torch.Tensor | None = None, causal: bool = True):
    """Launch backward route ``name``'s two kernels (``dq``, then
    ``dkdv``) on CUDA tensors; raises if that route cannot take them.
    :func:`attention_bwd` calls it with :func:`route_bwd`'s choice; a
    caller may name another route that takes the operands, to hold or
    time one design against another."""
    lengths = _check_bwd(q, k, v, o, do, lengths)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash_attention backward kernel for "
                           f"{q.device}")
    if any(t.device != q.device for t in (k, v, o, do, lengths)):
        raise ValueError("all operands must be on one device")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside 1..{MAX_HEAD_DIM}")
    q, k, v, o = (t.contiguous() for t in (q, k, v, o))
    do = do.to(q.dtype).contiguous()
    if name not in BWD_ROUTES:
        raise ValueError(f"unknown backward route {name!r}; routes are "
                         f"{BWD_ROUTES}")
    if name == "wgmma" and route_bwd(q, k, v, o, do) != "wgmma":
        raise ValueError("backward route wgmma takes bfloat16, head_dim a "
                         f"multiple of 16 up to {BWD_WGMMA_HEAD_DIM} and "
                         "TMA-legal q, k, v, o, do")
    lens = lengths.to(torch.int32).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # each row's lse and Delta, from dq for dkdv; the wgmma route's rows
    # padded to whole 64-row tiles, which its dkdv reads by bulk copy
    rows = sq if name == "simt" else -(-sq // _KEYS_PER_TILE) * _KEYS_PER_TILE
    lse, delta = torch.empty((2, b, h, rows), dtype=torch.float32,
                             device=q.device)
    shape = (b, h, kv, sq, sk, d, int(causal), 1.0 / math.sqrt(d))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (int(q.dtype == torch.bfloat16), stream) if name == "simt" \
        else (stream,)
    suffix = "_wgmma" if name == "wgmma" else ""
    err = build.entry("flash_attention_bwd",
                      f"lm_flash_attention_bwd_dq{suffix}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lens.data_ptr(), dq.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *shape, *tail)
    _count_bwd("dq", name)
    build.check(err, f"flash_attention backward (dq, {name})")
    err = build.entry("flash_attention_bwd",
                      f"lm_flash_attention_bwd_dkdv{suffix}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lens.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *shape, *tail)
    _count_bwd("dkdv", name)
    build.check(err, f"flash_attention backward (dkdv, {name})")
    return dq, dk, dv


def _count_bwd(kernel: str, name: str) -> None:
    flash_attention.backward_launches += 1
    flash_attention.backward_by_route[kernel][name] += 1


def run_route(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lengths: torch.Tensor | None = None, causal: bool = True, *,
              partial: bool = False):
    """Launch route ``name``'s kernel on CUDA tensors; raises if that
    kernel cannot take them.  :func:`flash_attention` calls it with
    :func:`route`'s choice; a caller may name another route that takes
    the operands, to hold or time one kernel against another.  With
    ``partial``, :func:`flash_attention_partial`'s output: ``(o, lse)``,
    float32, on a route of :data:`PARTIAL_ROUTES`, decode's rows and no
    causal mask."""
    lengths = _check(q, k, v, lengths)
    kernel = "flash_attention_partial" if partial else "flash_attention"
    if q.device.type != "cuda":
        raise RuntimeError(f"no {kernel} kernel for {q.device}")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside 1..{MAX_HEAD_DIM}")
    if k.device != q.device or v.device != q.device \
            or lengths.device != q.device:
        raise ValueError("all operands must be on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    routes = PARTIAL_ROUTES if partial else ROUTES
    if name not in routes:
        raise ValueError(f"unknown route {name!r}; {kernel}'s routes are "
                         f"{routes}")
    if partial and (causal or not _decode_rows(q, k)):
        raise ValueError(f"flash_attention_partial takes at most "
                         f"{DECODE_ROWS} query rows per KV head, no causal "
                         "mask")
    if name == "wgmma" and (q.dtype != torch.bfloat16 or d % 16
                            or not build.tma_legal(q, k, v)):
        raise ValueError("route wgmma takes bfloat16, head_dim a multiple "
                         "of 16 and TMA-legal q, k, v")
    if name == "split" and h // kv * sq > DECODE_ROWS:
        raise ValueError(f"route split takes at most {DECODE_ROWS} query "
                         "rows per KV head")
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=torch.float32 if partial else q.dtype,
                      device=q.device)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32,
                      device=q.device) if partial else None
    result = (out, lse) if partial else out
    if out.numel() == 0:
        return result
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            out.data_ptr())
    shape = (b, h, kv, sq, sk, d, int(causal), 1.0 / math.sqrt(d))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if name == "wgmma":
        err = build.entry("flash_attention", "lm_flash_attention_wgmma")(
            *ptrs, *shape, stream)
    else:
        split, _part = _split(name, q, k, stream)
        err = build.entry("flash_attention", "lm_flash_attention")(
            *ptrs, lse.data_ptr() if partial else None, *shape,
            int(q.dtype == torch.bfloat16), *split, stream)
    counter = flash_attention_partial if partial else flash_attention
    counter.launches += 1
    counter.by_route[name] += 1
    build.check(err, f"{kernel} ({name})")
    return result


def _split(name: str, q, k, stream: int):
    """The ``split`` route's arguments (tiles a block, the partials'
    pointer, the counters' pointer; zeros for ``simt``) and the partials'
    tensor, which the caller keeps until the launch is queued."""
    if name != "split":
        return (0, None, None), None
    b, _, _, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    tiles = -(-sk // _KEYS_PER_TILE)
    splits = -(-tiles // SPLIT_TILES)
    part = torch.empty((b * kv * splits * DECODE_ROWS * (d + 2),),
                       dtype=torch.float32, device=q.device)
    return (SPLIT_TILES, part.data_ptr(),
            _counters(q.device, stream, b * kv).data_ptr()), part


def _counters(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed arrival counters for launches on ``stream``
    (kept, since each launch leaves them at 0 again)."""
    key = (str(device), stream)
    have = _COUNTERS.get(key)
    if have is None or have.numel() < n:
        have = torch.zeros((max(n, 256),), dtype=torch.int32, device=device)
        _COUNTERS[key] = have
    return have


def _check_bwd(q, k, v, o, do, lengths) -> torch.Tensor:
    """Validate the backward's operands; returns ``lengths``."""
    lengths = _check(q, k, v, lengths)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError("o and do must have q's shape (and o its type)")
    return lengths


def _check(q, k, v, lengths) -> torch.Tensor:
    """Validate the operands; returns ``lengths`` (all ``Sk`` for
    ``None``)."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes q, k, v of one type, "
                        "float32 or bfloat16")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("q must be (B, H, Sq, D), k and v (B, KV, Sk, D)")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if lengths is None:
        lengths = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must have shape ({b},)")
    return lengths


#: kernel launches made through this wrapper (the CPU path counts none),
#: in all and by route; the backward's apart, by kernel and route
flash_attention.launches = 0
flash_attention.by_route = dict.fromkeys(ROUTES, 0)
flash_attention.backward_launches = 0
flash_attention.backward_by_route = {k: dict.fromkeys(BWD_ROUTES, 0)
                                     for k in BWD_KERNELS}
#: the partial output's launches, in all and by route
flash_attention_partial.launches = 0
flash_attention_partial.by_route = dict.fromkeys(PARTIAL_ROUTES, 0)
