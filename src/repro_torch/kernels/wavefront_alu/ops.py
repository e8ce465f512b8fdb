"""Public wrapper of the wavefront ALU: the CUDA kernel for a CUDA
tensor, the plain version (:mod:`.ref`) for a CPU tensor."""
from __future__ import annotations

import torch

from .. import build
from .ref import OPS, TILE_T, wavefront_alu_ref


def wavefront_alu(a: torch.Tensor, b: torch.Tensor, init: torch.Tensor,
                  active: torch.Tensor, op: str = "add") -> torch.Tensor:
    """``out = active[tile] ? op(a, b) : init`` over ``(T, L)`` float32,
    in tiles of :data:`TILE_T` rows (the last one may be ragged);
    ``active`` is the ``(ceil(T / 8),)`` tile bitmap.  Bit-exact to the
    reference's float32 rules on either device."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    if not (a.dtype == b.dtype == init.dtype == torch.float32):
        raise TypeError("wavefront_alu takes float32 a, b and init")
    if a.dim() != 2 or a.shape != b.shape or a.shape != init.shape:
        raise ValueError("a, b and init must share one (T, L) shape")
    rows, lanes = a.shape
    tiles = -(-rows // TILE_T)
    if active.shape != (tiles,):
        raise ValueError(f"active must have shape ({tiles},)")
    if a.device.type == "cpu":
        return wavefront_alu_ref(a, b, init, active, op)
    if a.device.type != "cuda":
        raise RuntimeError(f"no wavefront_alu kernel for {a.device}")
    a, b, init = a.contiguous(), b.contiguous(), init.contiguous()
    act = active.to(torch.int32).contiguous()
    for t in (b, init, act):
        if t.device != a.device:
            raise ValueError("all operands must be on one device")
    out = torch.empty_like(a)
    fn = build.entry("wavefront_alu")
    err = fn(a.data_ptr(), b.data_ptr(), init.data_ptr(), act.data_ptr(),
             out.data_ptr(), rows, lanes, OPS.index(op),
             torch.cuda.current_stream(a.device).cuda_stream)
    wavefront_alu.launches += 1
    build.check(err, "wavefront_alu")
    return out


#: kernel launches made through this wrapper (the CPU path counts none)
wavefront_alu.launches = 0
