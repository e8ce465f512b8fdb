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

The gradient (:func:`matmul_bwd`) is two more launches of the same
kernels: ``dA = dC @ B^T`` under the forward's ``row_active`` (an
inactive tile's ``dA`` rows are zero, as its output was), and ``dB =
A^T @ dC`` with ``dC`` zeroed on inactive tiles, its contracted axis
(the forward's ``M``) padded with zero rows to a multiple of
:data:`PAD_K`, so ``A^T``'s rows are TMA-legal and a bfloat16 ``dB``
stays on ``wgmma``.  :func:`wavefront_matmul` goes through its
``torch.autograd.Function`` only when a gradient is wanted, so a run
under ``no_grad`` (the serve) launches what it launched before.  On a
CPU tensor the backward is :func:`.ref.wavefront_matmul_ref_bwd`.
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
#: ``dB``'s contracted axis is padded to a multiple of this many rows:
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
    m, k = a.shape[-2], a.shape[-1]
    legal = build.tma_legal(a, b)
    if legal and m <= SMALL_M \
            and small_m_smem(m, k, a.element_size()) <= SMEM_LIMIT:
        return "small_m"
    if legal and a.dtype == torch.bfloat16:
        return "wgmma"
    return "simt"


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
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Matmul.apply(a, b, row_active)
    return _forward(a, b, row_active)


def _forward(a, b, row_active):
    if build.plain(a):
        return wavefront_matmul_ref(a, b, row_active)
    a, b = a.contiguous(), b.contiguous()
    return run_route(route(a, b), a, b, row_active)


class _Matmul(torch.autograd.Function):
    """The forward kernel, and :func:`matmul_bwd` as its gradient."""

    @staticmethod
    def forward(ctx, a, b, row_active):
        ctx.save_for_backward(a, b, row_active)
        return _forward(a, b, row_active)

    @staticmethod
    def backward(ctx, dc):
        a, b, row_active = ctx.saved_tensors
        da, db = matmul_bwd(a, b, row_active, dc)
        return da, db, None


def matmul_bwd(a: torch.Tensor, b: torch.Tensor, row_active: torch.Tensor,
               dc: torch.Tensor):
    """``(dA, dB)`` of :func:`wavefront_matmul` at output gradient ``dc``.
    A CPU or ``meta`` tensor takes :func:`.ref.wavefront_matmul_ref_bwd`; a CUDA
    tensor launches the kernel twice (the module docstring) or raises."""
    _check(a, b, row_active)
    if dc.shape != a.shape[:-1] + b.shape[-1:]:
        raise ValueError(f"dc has shape {tuple(dc.shape)}")
    if build.plain(a):
        return wavefront_matmul_ref_bwd(a, b, row_active, dc)
    dc = dc.to(a.dtype).contiguous()
    bt = b.transpose(-1, -2).contiguous()
    da = _launch(route(dc, bt), dc, bt, row_active, "da")
    m, k = a.shape[-2], a.shape[-1]
    mp = -(-m // PAD_K) * PAD_K
    keep = tile_mask(row_active, m)[..., None]
    dcm = a.new_zeros(dc.shape[:-2] + (mp, dc.shape[-1]))
    dcm[..., :m, :] = torch.where(keep, dc, 0)
    at = a.new_zeros(a.shape[:-2] + (k, mp))
    at[..., :m] = a.transpose(-1, -2)
    every = torch.ones(a.shape[:-2] + (-(-k // TILE_M),), dtype=torch.int32,
                       device=a.device)
    db = _launch(route(at, dcm), at, dcm, every, "db")
    return da, db


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
    ``product`` (``"da"`` or ``"db"``), as the backward's."""
    _check(a, b, row_active)
    if a.device.type != "cuda":
        raise RuntimeError(f"no wavefront_matmul kernel for {a.device}")
    if b.device != a.device or row_active.device != a.device:
        raise ValueError("all operands must be on one device")
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
        wavefront_matmul.backward_by_route[product][name] += 1
    build.check(err, f"wavefront_matmul ({name})")
    return out


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
#: in all and by route; the backward's apart, by product and route
wavefront_matmul.launches = 0
wavefront_matmul.by_route = dict.fromkeys(ROUTES, 0)
wavefront_matmul.backward_launches = 0
wavefront_matmul.backward_by_route = {p: dict.fromkeys(ROUTES, 0)
                                      for p in BWD_PRODUCTS}
