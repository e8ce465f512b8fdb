"""Public wrapper of the DOT/SUM extension unit: the CUDA kernel for a
CUDA tensor, the plain version (:mod:`.ref`) for a CPU tensor."""
from __future__ import annotations

import torch

from .. import build
from .ref import TILE_T, dot_product_ref


def dot_product(a: torch.Tensor, b: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
    """``<a, b>`` over the active 8-row tiles in ``det_sum`` order.

    ``a, b``: ``(T, L)`` -> float32 scalar (the TPU kernel's function) or
    ``(B, T, L)`` -> ``(B,)``, one sum per eGPU core; float32 or
    bfloat16 (upcast).  ``L`` must be a power of two (the halving tree).
    """
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("dot_product takes float32 or bfloat16 a and b")
    if a.shape != b.shape or a.dim() not in (2, 3):
        raise ValueError("a and b must share one (T, L) or (B, T, L) shape")
    rows, lanes = a.shape[-2:]
    if lanes < 1 or lanes & (lanes - 1) or lanes > 1024:
        raise ValueError("the lane count must be a power of two <= 1024")
    tiles = -(-rows // TILE_T)
    if active.shape != a.shape[:-2] + (tiles,):
        raise ValueError(f"active must have shape {a.shape[:-2] + (tiles,)}")
    if a.device.type == "cpu":
        return dot_product_ref(a, b, active)
    if a.device.type != "cuda":
        raise RuntimeError(f"no dot_product kernel for {a.device}")
    batch = a.shape[0] if a.dim() == 3 else 1
    a, b = a.contiguous(), b.contiguous()
    act = active.to(torch.int32).contiguous()
    for t in (b, act):
        if t.device != a.device:
            raise ValueError("all operands must be on one device")
    out = torch.empty((batch,), dtype=torch.float32, device=a.device)
    fn = build.entry("dot_product")
    err = fn(a.data_ptr(), b.data_ptr(), act.data_ptr(), out.data_ptr(),
             batch, rows, lanes, int(a.dtype == torch.bfloat16),
             torch.cuda.current_stream(a.device).cuda_stream)
    dot_product.launches += 1
    build.check(err, "dot_product")
    return out if a.dim() == 3 else out[0]


#: kernel launches made through this wrapper (the CPU path counts none)
dot_product.launches = 0
