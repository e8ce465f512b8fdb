"""Public wrapper of flash attention with KV-tile skipping: the CUDA
kernel for a CUDA tensor, the plain version (:mod:`.ref`) for a CPU
tensor."""
from __future__ import annotations

import math

import torch

from .. import build
from .ref import mha_ref

DTYPES = (torch.float32, torch.bfloat16)
#: the kernel against its plain version, ``|got - plain| <= atol + rtol *
#: |plain|``: both accumulate in float32, in other orders; a bfloat16
#: output may then round to the neighbouring value, one bf16 ulp, which
#: is at most 2^-7 of it
TOLERANCE = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -7)}
MAX_HEAD_DIM = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor | None = None,
                    causal: bool = True) -> torch.Tensor:
    """Online-softmax attention, output in ``q.dtype``.

    q: ``(B, H, Sq, D)``; k, v: ``(B, KV, Sk, D)`` with ``H % KV == 0``
    (query head ``h`` reads key/value head ``h // (H // KV)``); lengths:
    ``(B,)`` valid key count per batch entry (``None``: all ``Sk``).  A
    query at row ``i`` sees keys ``< lengths[b]`` and, when ``causal``,
    ``<= i + (Sk - Sq)``.  Any ``Sq``, ``Sk`` and ``D <= 128``.
    """
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
    if q.device.type == "cpu":
        return mha_ref(q, k, v, lengths, causal).to(q.dtype)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash_attention kernel for {q.device}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside 1..{MAX_HEAD_DIM}")
    if k.device != q.device or v.device != q.device \
            or lengths.device != q.device:
        raise ValueError("all operands must be on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.entry("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
             out.data_ptr(), b, h, kv, sq, sk, d, int(causal),
             1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    build.check(err, "flash_attention")
    return out


#: kernel launches made through this wrapper (the CPU path counts none)
flash_attention.launches = 0
