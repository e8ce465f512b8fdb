"""Public wrapper of the masked block matmul: the CUDA kernel for a CUDA
tensor, the plain version (:mod:`.ref`) for a CPU tensor."""
from __future__ import annotations

import torch

from .. import build
from .ref import TILE_M, wavefront_matmul_ref

DTYPES = (torch.float32, torch.bfloat16)
#: the kernel against its plain version, ``|got - plain| <= atol + rtol *
#: |plain|``: both accumulate in float32, in other orders; a bfloat16
#: output may then round to the neighbouring value, one bf16 ulp, which
#: is at most 2^-7 of it
TOLERANCE = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -7)}


def wavefront_matmul(a: torch.Tensor, b: torch.Tensor,
                     row_active: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` over float32 or bfloat16, float32 accumulation,
    output in ``a.dtype``; a row tile of :data:`TILE_M` rows whose
    ``row_active`` flag is 0 skips its K loop and is written as zeros.

    a: ``([E,] M, K)``, b: ``([E,] K, N)``, row_active:
    ``([E,] ceil(M / 128))``; any ``M``, ``N``, ``K`` (ragged tiles are
    masked).  The batch axis ``E`` runs one matrix per MoE expert in one
    launch.
    """
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError("wavefront_matmul takes a and b of one type, "
                        "float32 or bfloat16")
    if a.dim() != b.dim() or a.dim() not in (2, 3) \
            or a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m = a.shape[-2]
    tiles = a.shape[:-2] + (-(-m // TILE_M),)
    if tuple(row_active.shape) != tiles:
        raise ValueError(f"row_active must have shape {tiles}")
    if a.device.type == "cpu":
        return wavefront_matmul_ref(a, b, row_active)
    if a.device.type != "cuda":
        raise RuntimeError(f"no wavefront_matmul kernel for {a.device}")
    if b.device != a.device or row_active.device != a.device:
        raise ValueError("all operands must be on one device")
    batch = a.shape[0] if a.dim() == 3 else 1
    n, k = b.shape[-1], a.shape[-1]
    a, b = a.contiguous(), b.contiguous()
    act = row_active.to(torch.int32).contiguous()
    out = torch.empty(a.shape[:-1] + (n,), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    fn = build.entry("wavefront_matmul")
    err = fn(a.data_ptr(), b.data_ptr(), act.data_ptr(), out.data_ptr(),
             batch, m, n, k, int(a.dtype == torch.bfloat16),
             torch.cuda.current_stream(a.device).cuda_stream)
    wavefront_matmul.launches += 1
    build.check(err, "wavefront_matmul")
    return out


#: kernel launches made through this wrapper (the CPU path counts none)
wavefront_matmul.launches = 0
