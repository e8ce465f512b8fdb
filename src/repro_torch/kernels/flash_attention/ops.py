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

The gradient (``csrc/flash_attention_bwd.cu``) runs through
:func:`attention_bwd`: two kernels, ``dq`` a query tile and ``dkdv`` a
key tile, on one of two routes that :func:`route_bwd` picks by an
explicit rule (``run_bwd_route`` names one):

* ``"wgmma"``: bfloat16, ``head_dim`` a multiple of 16 up to
  :data:`BWD_WGMMA_HEAD_DIM`, TMA-legal q, k, v, o and do; TMA and
  ``wgmma`` on the tensor cores;
* ``"simt"``: everything else (float32, other head dims, operands TMA
  cannot read): the CUDA cores in float32.

:func:`flash_attention` goes through its ``torch.autograd.Function``
only when a gradient is wanted (grad mode on and an operand that
requires one), so a run under ``no_grad`` (the serve) launches what it
launched before.  On a CPU tensor the backward is :func:`.ref.
mha_ref_bwd`.
"""
from __future__ import annotations

import math

import torch

from .. import build
from .ref import mha_ref, mha_ref_bwd

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
    lengths = _check(q, k, v, lengths)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, lengths, causal)
    return _forward(q, k, v, lengths, causal)


def _forward(q, k, v, lengths, causal):
    if build.plain(q):
        return mha_ref(q, k, v, lengths, causal).to(q.dtype)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return run_route(route(q, k, v), q, k, v, lengths, causal)


class _Attention(torch.autograd.Function):
    """The forward kernel, and :func:`attention_bwd` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal):
        out = _forward(q, k, v, lengths, causal)
        ctx.save_for_backward(q, k, v, out, lengths)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lengths = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, do, lengths, ctx.causal)
        return dq, dk, dv, None, None


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
    if build.plain(q):
        return mha_ref_bwd(q, k, v, o, do, lengths, causal)
    q, k, v, o = (t.contiguous() for t in (q, k, v, o))
    do = do.to(q.dtype).contiguous()
    return run_bwd_route(route_bwd(q, k, v, o, do), q, k, v, o, do, lengths,
                         causal)


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
              lengths: torch.Tensor | None = None,
              causal: bool = True) -> torch.Tensor:
    """Launch route ``name``'s kernel on CUDA tensors; raises if that
    kernel cannot take them.  :func:`flash_attention` calls it with
    :func:`route`'s choice; a caller may name another route that takes
    the operands, to hold or time one kernel against another."""
    lengths = _check(q, k, v, lengths)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash_attention kernel for {q.device}")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside 1..{MAX_HEAD_DIM}")
    if k.device != q.device or v.device != q.device \
            or lengths.device != q.device:
        raise ValueError("all operands must be on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if name not in ROUTES:
        raise ValueError(f"unknown route {name!r}; routes are {ROUTES}")
    if name == "wgmma" and (q.dtype != torch.bfloat16 or d % 16
                            or not build.tma_legal(q, k, v)):
        raise ValueError("route wgmma takes bfloat16, head_dim a multiple "
                         "of 16 and TMA-legal q, k, v")
    if name == "split" and h // kv * sq > DECODE_ROWS:
        raise ValueError(f"route split takes at most {DECODE_ROWS} query "
                         "rows per KV head")
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            out.data_ptr(), b, h, kv, sq, sk, d, int(causal),
            1.0 / math.sqrt(d))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if name == "wgmma":
        err = build.entry("flash_attention", "lm_flash_attention_wgmma")(
            *args, stream)
    else:
        split = (0, None, None)         # tiles a block, partials, counters
        if name == "split":
            tiles = -(-sk // _KEYS_PER_TILE)
            splits = -(-tiles // SPLIT_TILES)
            part = torch.empty((b * kv * splits * DECODE_ROWS * (d + 2),),
                               dtype=torch.float32, device=q.device)
            split = (SPLIT_TILES, part.data_ptr(),
                     _counters(q.device, stream, b * kv).data_ptr())
        err = build.entry("flash_attention", "lm_flash_attention")(
            *args, int(q.dtype == torch.bfloat16), *split, stream)
    flash_attention.launches += 1
    flash_attention.by_route[name] += 1
    build.check(err, f"flash_attention ({name})")
    return out


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
