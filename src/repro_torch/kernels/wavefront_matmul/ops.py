"""Public wrapper of the masked block matmul: a CUDA kernel for a CUDA
tensor, the plain version (:mod:`.ref`) for a CPU (or ``meta``) tensor.

Three hand-written kernels compute the function (``csrc/
wavefront_matmul.cu``); :func:`route` picks one by an explicit rule, and
a CUDA tensor always launches the routed kernel or raises:

* ``"small_m"``: at most :data:`SMALL_M` rows per expert (decode), float32
  or bfloat16, with TMA-legal operands; streams B once on the CUDA cores;
* ``"wgmma"``: bfloat16 with TMA-legal operands; TMA and ``wgmma`` on the
  tensor cores;
* ``"simt"``: everything else (float32 above :data:`SMALL_M` rows, where
  TF32 tensor cores would break float32's tolerance; ragged or misaligned
  rows TMA cannot read): the CUDA cores in float32.

The gradient (:func:`matmul_bwd`), ``dA = dC @ B^T`` under the forward's
``row_active`` (an inactive tile's ``dA`` rows are zero, as its output
was) and ``dB = A^T @ dC`` over the active tiles' rows, has its own rule,
:func:`route_bwd`:

* ``"wgmma"``: bfloat16 with TMA-legal ``A``, ``B`` and ``dC``; a fourth
  kernel reads the three in place (no transposed, padded or masked copy)
  and computes both products in one launch;
* everything else (float32; operands TMA cannot take) runs the forward's
  kernels on copies: ``B^T``, and ``dC`` zeroed on inactive tiles with
  ``A^T`` beside it, their contracted axis (the forward's ``M``) padded
  with zero rows to a multiple of :data:`PAD_K`; each product on
  ``"small_m"`` or ``"simt"`` as :func:`route` picks for those copies.

``"copies"``, the bfloat16 gradient's first design (the forward's
``wgmma`` kernel on those copies), is kept for timing and checking the
new kernel against (:func:`run_bwd_route`); :func:`route_bwd` never picks
it.  The product and its gradient are the operators
``torch.ops.repro_torch.wavefront_matmul`` and ``.wavefront_matmul_bwd``
(``torch.library.custom_op``), each with a fake implementation that
allocates what the CUDA route allocates (the outputs; the copies of the
copy-based routes are the workspace :func:`workspace_bytes` names), a
FLOP formula (the plain versions' products), and, once
:func:`register_dtensor_rules` has run, a ``DTensor`` sharding rule.
The backward is recorded only when a gradient is wanted, so a run under
``no_grad`` (the serve) launches what it launched before.  On a CPU
tensor the backward is :func:`.ref.wavefront_matmul_ref_bwd`; on a
``meta`` tensor each operator takes its fake implementation.
"""
from __future__ import annotations

import torch

from .. import build
from .ref import (TILE_M, tile_mask, wavefront_matmul_ref,
                  wavefront_matmul_ref_bwd)

DTYPES = (torch.float32, torch.bfloat16)
#: the kernel against its plain version, ``|got - plain| <= atol + rtol *
#: |plain|``: both accumulate in float32, in other orders; a bfloat16
#: output may then round to the neighbouring value, one bf16 ulp, which
#: is at most 2^-7 of it
TOLERANCE = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -7)}
ROUTES = ("wgmma", "small_m", "simt")
#: the backward's two products, counted apart from the forward's
BWD_PRODUCTS = ("da", "db")
#: the gradient's routes, by product: ``"wgmma"`` the in-place kernel;
#: ``"copies"`` the forward's ``wgmma`` kernel on copies (named only);
#: ``"small_m"``, ``"simt"`` the forward's kernels on copies
BWD_ROUTES = ("wgmma", "copies", "small_m", "simt")
#: the copies' contracted axis is padded to a multiple of this many rows:
#: 16-byte rows of ``A^T`` for bfloat16 (and float32)
PAD_K = 8
#: rows per expert up to which ``small_m`` takes the product
SMALL_M = 16
#: shared memory a block may use (H100, opted in), and ``small_m``'s
#: ring and partial sums beside A's rows (``csrc/wavefront_matmul.cu``)
SMEM_LIMIT = 227 * 1024
_RING_BYTES = 8 * 256 * 16
_PARTIAL_BYTES = 8 * 64 * 4


def small_m_smem(m: int, k: int, elem: int) -> int:
    """Shared memory of ``small_m`` for ``m`` rows: A's rows (``m``
    rounded up to a power of two), the copy ring, the partial sums."""
    mt = 1 << max(0, m - 1).bit_length()
    return -(-mt * k * elem // 16) * 16 + _RING_BYTES + _PARTIAL_BYTES * mt


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel that computes ``a @ b``: ``"small_m"``, ``"wgmma"`` or
    ``"simt"`` (see the module docstring).  A pure function of the
    operands' type, shape, layout and alignment."""
    return _route(a.shape[-2], a.shape[-1], a.dtype, build.tma_legal(a, b))


def _route(m: int, k: int, dtype, legal: bool) -> str:
    """:func:`route` for ``m`` rows contracting ``k``, given whether TMA
    can read both operands."""
    if legal and m <= SMALL_M \
            and small_m_smem(m, k, dtype.itemsize) <= SMEM_LIMIT:
        return "small_m"
    if legal and dtype == torch.bfloat16:
        return "wgmma"
    return "simt"


def route_bwd(a: torch.Tensor, b: torch.Tensor,
              dc: torch.Tensor) -> tuple[str, str]:
    """The routes of the gradient's products ``(dA, dB)`` (see the
    module docstring): ``("wgmma", "wgmma")`` for bfloat16 with TMA-legal
    ``a``, ``b`` and ``dc``; else, for each product, the forward's rule
    on its copies (``dC`` and ``B^T``; ``A^T`` and the masked ``dC``,
    padded to :data:`PAD_K` rows, fresh and so aligned), where
    ``"small_m"`` or ``"simt"``.  A pure function of the operands' type,
    shape, layout and alignment; never ``"copies"``."""
    if a.dtype == torch.bfloat16 and build.tma_legal(a, b, dc):
        return "wgmma", "wgmma"
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    el = a.element_size()
    mp = -(-m // PAD_K) * PAD_K
    da = _route(m, n, a.dtype, build.tma_legal(dc) and k * el % 16 == 0)
    db = _route(k, mp, a.dtype, n * el % 16 == 0)
    return tuple("simt" if r == "wgmma" else r for r in (da, db))


def wavefront_matmul(a: torch.Tensor, b: torch.Tensor,
                     row_active: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` over float32 or bfloat16, float32 accumulation,
    output in ``a.dtype``; a row tile of :data:`TILE_M` rows whose
    ``row_active`` flag is 0 skips its K loop and is written as zeros.

    a: ``([E,] M, K)``, b: ``([E,] K, N)``, row_active:
    ``([E,] ceil(M / 128))``; any ``M``, ``N``, ``K`` (ragged tiles are
    masked).  The batch axis ``E`` runs one matrix per MoE expert in one
    launch.  Differentiable in ``a`` and ``b`` (:func:`matmul_bwd`).
    """
    _check(a, b, row_active)
    return _matmul_op(a, b, row_active)


@torch.library.custom_op("repro_torch::wavefront_matmul", mutates_args=())
def _matmul_op(a: torch.Tensor, b: torch.Tensor,
               row_active: torch.Tensor) -> torch.Tensor:
    if build.plain(a):
        return wavefront_matmul_ref(a, b, row_active)
    a, b = a.contiguous(), b.contiguous()
    return run_route(route(a, b), a, b, row_active)


@_matmul_op.register_fake
def _(a, b, row_active):
    return a.new_empty(a.shape[:-1] + b.shape[-1:])


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dc):
    a, b, row_active = ctx.saved_tensors
    da, db = _matmul_bwd_op(a, b, row_active, dc)
    return da, db, None


_matmul_op.register_autograd(_backward, setup_context=_setup)


def matmul_bwd(a: torch.Tensor, b: torch.Tensor, row_active: torch.Tensor,
               dc: torch.Tensor):
    """``(dA, dB)`` of :func:`wavefront_matmul` at output gradient ``dc``.
    A CPU or ``meta`` tensor takes :func:`.ref.wavefront_matmul_ref_bwd`; a CUDA
    tensor launches the routes :func:`route_bwd` picks or raises."""
    _check(a, b, row_active)
    if dc.shape != a.shape[:-1] + b.shape[-1:]:
        raise ValueError(f"dc has shape {tuple(dc.shape)}")
    return _matmul_bwd_op(a, b, row_active, dc)


@torch.library.custom_op("repro_torch::wavefront_matmul_bwd",
                         mutates_args=())
def _matmul_bwd_op(a: torch.Tensor, b: torch.Tensor, row_active: torch.Tensor,
                   dc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if build.plain(a):
        return wavefront_matmul_ref_bwd(a, b, row_active, dc)
    a, b = a.contiguous(), b.contiguous()
    dc = dc.to(a.dtype).contiguous()
    routes = route_bwd(a, b, dc)
    if routes[0] == "wgmma":
        return _grad_wgmma(a, b, row_active, dc, BWD_PRODUCTS)
    return _grad_copies(a, b, row_active, dc, routes)


def run_bwd_route(name: str, a: torch.Tensor, b: torch.Tensor,
                  row_active: torch.Tensor, dc: torch.Tensor,
                  products=BWD_PRODUCTS):
    """The gradient on CUDA tensors by route ``name``: ``"wgmma"`` (only
    the products named in ``products``, in one launch; the others
    ``None``) or ``"copies"`` (the first design: the forward's
    :func:`route` for each copy, ``"wgmma"`` counted as ``"copies"``).
    Raises if the route cannot take the operands.  :func:`matmul_bwd`
    takes :func:`route_bwd`'s choice; a caller may name a route to hold
    or time one design against another."""
    _check(a, b, row_active)
    a, b = a.contiguous(), b.contiguous()
    dc = dc.to(a.dtype).contiguous()
    if name == "wgmma":
        return _grad_wgmma(a, b, row_active, dc, tuple(products))
    if name == "copies":
        return _grad_copies(a, b, row_active, dc, None)
    raise ValueError(f"unknown gradient route {name!r}; run_bwd_route "
                     f"takes 'wgmma' or 'copies'")


def _grad_wgmma(a, b, row_active, dc, products):
    """The in-place kernel: ``products`` of ``("da", "db")`` in one
    launch; each counted on ``"wgmma"``."""
    _device(a, b, row_active, dc)
    if a.dtype != torch.bfloat16 or not build.tma_legal(a, b, dc):
        raise ValueError("the gradient's route wgmma takes bfloat16 "
                         "operands TMA can read")
    if dc.shape != a.shape[:-1] + b.shape[-1:]:
        raise ValueError(f"dc has shape {tuple(dc.shape)}")
    da = torch.empty_like(a) if "da" in products else None
    db = torch.empty_like(b) if "db" in products else None
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    if 0 in (m, n, k):                 # nothing to contract: zeros
        return tuple(x.zero_() if x is not None else x for x in (da, db))
    act = row_active.to(torch.int32).contiguous()
    which = ("da" in products) | ("db" in products) << 1
    err = build.entry("wavefront_matmul", "lm_wavefront_matmul_grad_wgmma")(
        a.data_ptr(), b.data_ptr(), dc.data_ptr(), act.data_ptr(),
        da.data_ptr() if da is not None else None,
        db.data_ptr() if db is not None else None,
        a.shape[0] if a.dim() == 3 else 1, m, n, k, which,
        torch.cuda.current_stream(a.device).cuda_stream)
    wavefront_matmul.backward_launches += 1
    for p in products:
        wavefront_matmul.backward_by_route[p]["wgmma"] += 1
    build.check(err, "wavefront_matmul gradient (wgmma)")
    return da, db


def _grad_copies(a, b, row_active, dc, routes):
    """The forward's kernels on copies: ``dA = dC @ B^T`` and ``dB =
    A^T @ dC``, ``dC`` masked and both padded to :data:`PAD_K` rows
    (module docstring); ``routes`` the products' routes, or ``None`` for
    the forward's :func:`route` of each copy (the ``"copies"`` route)."""
    bt = b.transpose(-1, -2).contiguous()
    da = _launch(routes[0] if routes else route(dc, bt), dc, bt, row_active,
                 "da")
    m, k = a.shape[-2], a.shape[-1]
    mp = -(-m // PAD_K) * PAD_K
    keep = tile_mask(row_active, m)[..., None]
    dcm = a.new_zeros(dc.shape[:-2] + (mp, dc.shape[-1]))
    dcm[..., :m, :] = torch.where(keep, dc, 0)
    at = a.new_zeros(a.shape[:-2] + (k, mp))
    at[..., :m] = a.transpose(-1, -2)
    every = torch.ones(a.shape[:-2] + (-(-k // TILE_M),), dtype=torch.int32,
                       device=a.device)
    db = _launch(routes[1] if routes else route(at, dcm), at, dcm, every,
                 "db")
    return da, db


@_matmul_bwd_op.register_fake
def _(a, b, row_active, dc):
    return a.new_empty(a.shape), b.new_empty(b.shape)


def workspace_bytes(op, a: torch.Tensor, b: torch.Tensor) -> int:
    """Bytes the CUDA route of ``op`` (the product or its gradient)
    allocates for itself and frees before it returns, for ``a`` and
    ``b`` of any device (``meta`` included; ``dC``, of ``B``'s row
    width, made contiguous by the operator).  The product: none.  The
    gradient on ``"wgmma"`` (bfloat16, TMA-legal): none, as it reads A,
    B, dC and the tile flags where they lie.  On copies: ``B^T``, the
    masked ``dC`` (once as ``torch.where`` makes it, once padded to
    :data:`PAD_K` rows), ``A^T`` padded alike and the all-active tile
    flags, counted as if all were live at once."""
    if op is not torch.ops.repro_torch.wavefront_matmul_bwd.default:
        return 0
    if a.dtype == torch.bfloat16 and build.tma_legal(a, b):
        return 0
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    e = a.shape[0] if a.dim() == 3 else 1
    mp = -(-m // PAD_K) * PAD_K
    return e * ((n * k + m * n + mp * n + k * mp) * a.element_size()
                + -(-k // TILE_M) * 4)


def _register_flops() -> None:
    """The FLOP formulas: the plain versions' products (2 a
    multiply-add, as ``FlopCounterMode`` counts a matmul), ``A B`` for
    the forward and ``dC B^T`` and ``A^T dC`` for the gradient."""
    from torch.utils.flop_counter import register_flop_formula

    def products(a, b, n):
        e = a[0] if len(a) == 3 else 1
        return 2 * n * e * a[-2] * a[-1] * b[-1]

    @register_flop_formula(torch.ops.repro_torch.wavefront_matmul)
    def _(a, b, row_active, *, out_shape=None, **kwargs):
        return products(a, b, 1)

    @register_flop_formula(torch.ops.repro_torch.wavefront_matmul_bwd)
    def _(a, b, row_active, dc, *, out_shape=None, **kwargs):
        return products(a, b, 2)


_register_flops()


def register_dtensor_rules() -> None:
    """Register both operators' ``DTensor`` sharding rules (idempotent).
    On each mesh dim: the expert (batch) axis of a 3-D product sharded
    in every operand and output, ``row_active`` with it; ``A``'s rows
    sharded (``C``'s rows with them; the gradient's ``dB`` a partial sum)
    where each shard holds whole 128-row tiles, ``row_active``'s tiles
    sharded with them, or where all rows are one tile, ``row_active``
    replicated; ``B``'s columns sharded (``C``'s columns with them; the
    gradient's ``dA`` a partial sum); the contracted axis sharded in
    ``A`` and ``B`` (``C`` a partial sum; the gradient's ``dA`` and
    ``dB`` sharded); or all replicated.  DTensor redistributes any other
    placement to one of these, and counts it."""
    if _RULES:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    r, p = Replicate(), Partial()

    def row_tiles(a, row_active):
        """``row_active``'s placement where ``A``'s rows are sharded:
        ``Shard`` of its tiles where A's row shards (as A is placed now)
        are whole tiles, ``Replicate`` where all rows are one tile."""
        rows, shards = a.shape[-2], 1
        for n, pl in zip(a.mesh.shape, a.placements):
            shards *= n if pl == Shard(a.ndim - 2) else 1
        out = []
        if rows % TILE_M == 0 and (rows // TILE_M) % shards == 0:
            out.append(Shard(row_active.ndim - 1))
        if rows <= TILE_M:
            out.append(r)
        return out

    @register_sharding(torch.ops.repro_torch.wavefront_matmul.default)
    def _(a, b, row_active):
        la, lb = a.ndim - 1, b.ndim - 1
        out = [([r], [r, r, r]),
               ([Shard(la)], [r, Shard(lb), r]),
               ([p], [Shard(la), Shard(lb - 1), r])]
        out += [([Shard(la - 1)], [Shard(la - 1), r, t])
                for t in row_tiles(a, row_active)]
        if a.ndim == 3:
            out.append(([Shard(0)], [Shard(0)] * 3))
        return out

    @register_sharding(torch.ops.repro_torch.wavefront_matmul_bwd.default)
    def _(a, b, row_active, dc):
        la, lb = a.ndim - 1, b.ndim - 1
        out = [([r, r], [r, r, r, r]),
               ([p, Shard(lb)], [r, Shard(lb), r, Shard(la)]),
               ([Shard(la), Shard(lb - 1)], [Shard(la), Shard(lb - 1), r, r])]
        out += [([Shard(la - 1), p], [Shard(la - 1), r, t, Shard(la - 1)])
                for t in row_tiles(a, row_active)]
        if a.ndim == 3:
            out.append(([Shard(0)] * 2, [Shard(0)] * 4))
        return out

    _RULES.append(True)


_RULES: list = []


def run_route(name: str, a: torch.Tensor, b: torch.Tensor,
              row_active: torch.Tensor) -> torch.Tensor:
    """Launch route ``name``'s kernel on CUDA tensors; raises if that
    kernel cannot take them.  :func:`wavefront_matmul` calls it with
    :func:`route`'s choice; a caller may name another route that takes
    the operands, to hold or time one kernel against another."""
    return _launch(name, a, b, row_active)


def _launch(name: str, a: torch.Tensor, b: torch.Tensor,
            row_active: torch.Tensor, product: str | None = None):
    """:func:`run_route`, counted as the forward's launch or, with
    ``product`` (``"da"`` or ``"db"``), as the backward's on copies
    (the ``wgmma`` kernel there counted as ``"copies"``)."""
    _check(a, b, row_active)
    _device(a, b, row_active)
    a, b = a.contiguous(), b.contiguous()
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    bf16 = a.dtype == torch.bfloat16
    if name not in ROUTES:
        raise ValueError(f"unknown route {name!r}; routes are {ROUTES}")
    if name != "simt" and not build.tma_legal(a, b):
        raise ValueError(f"route {name} needs TMA-legal operands")
    if name == "wgmma" and not bf16:
        raise ValueError("route wgmma takes bfloat16 only")
    if name == "small_m" and (m > SMALL_M or small_m_smem(
            m, k, a.element_size()) > SMEM_LIMIT):
        raise ValueError(f"route small_m takes at most {SMALL_M} rows and "
                         f"{SMEM_LIMIT} bytes of shared memory")
    batch = a.shape[0] if a.dim() == 3 else 1
    act = row_active.to(torch.int32).contiguous()
    out = torch.empty(a.shape[:-1] + (n,), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(a.device).cuda_stream
    ptrs = (a.data_ptr(), b.data_ptr(), act.data_ptr(), out.data_ptr(),
            batch, m, n, k)
    if name == "wgmma":
        err = build.entry("wavefront_matmul", "lm_wavefront_matmul_wgmma")(
            *ptrs, stream)
    elif name == "small_m":
        err = build.entry("wavefront_matmul", "lm_wavefront_matmul_small_m")(
            *ptrs, int(bf16), stream)
    else:
        err = build.entry("wavefront_matmul", "lm_wavefront_matmul")(
            *ptrs, int(bf16), stream)
    if product is None:
        wavefront_matmul.launches += 1
        wavefront_matmul.by_route[name] += 1
    else:
        wavefront_matmul.backward_launches += 1
        wavefront_matmul.backward_by_route[product][
            "copies" if name == "wgmma" else name] += 1
    build.check(err, f"wavefront_matmul ({name})")
    return out


def _device(a, *rest) -> None:
    if a.device.type != "cuda":
        raise RuntimeError(f"no wavefront_matmul kernel for {a.device}")
    if any(t.device != a.device for t in rest):
        raise ValueError("all operands must be on one device")


def _check(a, b, row_active) -> None:
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError("wavefront_matmul takes a and b of one type, "
                        "float32 or bfloat16")
    if a.dim() != b.dim() or a.dim() not in (2, 3) \
            or a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    tiles = a.shape[:-2] + (-(-a.shape[-2] // TILE_M),)
    if tuple(row_active.shape) != tiles:
        raise ValueError(f"row_active must have shape {tiles}")


#: kernel launches made through this wrapper (the CPU path counts none),
#: in all and by route; the backward's apart (``"wgmma"``: one launch for
#: both products), and by product and route
wavefront_matmul.launches = 0
wavefront_matmul.by_route = dict.fromkeys(ROUTES, 0)
wavefront_matmul.backward_launches = 0
wavefront_matmul.backward_by_route = {p: dict.fromkeys(BWD_ROUTES, 0)
                                      for p in BWD_PRODUCTS}
