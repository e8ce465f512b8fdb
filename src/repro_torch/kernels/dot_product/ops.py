"""Public wrappers of the DOT/SUM extension unit: the CUDA kernels for
CUDA tensors, the plain versions (:mod:`.ref`) for CPU (and ``meta``)
tensors, never a fallback from one to the other.  Two routes, one source
(``csrc/dot_product.cu``), counted in ``dot_product.by_route``:

* ``step`` (:func:`ext_step`, :func:`ext_step_launcher`): the eGPU main
  path's DOT/SUM instruction step, one launch for every core of a batch,
  in place on the register file;
* ``tile`` (:func:`dot_product`): the TPU kernel's function.
"""
from __future__ import annotations

import torch

from .. import build, egpu_step
from .ref import TILE_T, dot_product_ref, ext_step_ref


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
    if build.plain(a):
        return dot_product_ref(a, b, active)
    if a.device.type != "cuda":
        raise RuntimeError(f"no dot_product kernel for {a.device}")
    if not (b.device == active.device == a.device):
        raise ValueError("all operands must be on one device")
    batch = a.shape[0] if a.dim() == 3 else 1
    a, b = (t if t.is_contiguous() else t.contiguous() for t in (a, b))
    if active.dtype != torch.int32 or not active.is_contiguous():
        active = active.to(torch.int32).contiguous()
    out = torch.empty((batch,), dtype=torch.float32, device=a.device)
    err = build.entry("dot_product")(
        a.data_ptr(), b.data_ptr(), active.data_ptr(), out.data_ptr(),
        batch, rows, lanes, int(a.dtype == torch.bfloat16),
        build.stream(a.device))
    dot_product.launches += 1
    dot_product.by_route["tile"] += 1
    build.check(err, "dot_product")
    return out if a.dim() == 3 else out[0]


def ext_step_launcher(regs: torch.Tensor, masks: torch.Tensor, opcodes):
    """The ``step`` route prepared once over a register file on the card
    (:func:`repro_torch.kernels.egpu_step.launcher`): returns
    ``launch(row_ptr, pred_ptr)``, one ctypes call a step."""
    return egpu_step.launcher("dot_product", "egpu_ext_step", dot_product,
                              regs, masks, opcodes)


def ext_step(regs: torch.Tensor, tr: torch.Tensor, masks: torch.Tensor,
             pred, opcodes) -> None:
    """One DOT/SUM instruction step of a batch of cores, in place
    (arguments as in :mod:`repro_torch.kernels.egpu_step`; ``opcodes`` =
    DOT's, SUM's): thread 0's Rd of each core that runs one gets the sum
    in ``det_sum`` order (:func:`.ref.ext_step_ref`)."""
    egpu_step.check(regs, masks, tr, pred)
    if build.plain(regs):
        ext_step_ref(regs, tr, masks, pred, opcodes)
        return
    egpu_step.check_dense(tr, pred)
    ext_step_launcher(regs, masks, opcodes)(
        tr.data_ptr(), 0 if pred is None else pred.data_ptr())


#: kernel launches made through these wrappers, in all and by route (the
#: CPU path counts none)
dot_product.launches = 0
dot_product.by_route = {"step": 0, "tile": 0}
