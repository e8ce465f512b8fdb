"""Public wrappers of the wavefront ALU: the CUDA kernels for CUDA
tensors, the plain versions (:mod:`.ref`) for CPU tensors, never a
fallback from one to the other.  Two routes, one source
(``csrc/wavefront_alu.cu``), counted in ``wavefront_alu.by_route``:

* ``step`` (:func:`fp_step`, :func:`fp_step_launcher`): the eGPU main
  path's FP instruction step, one launch for every core of a batch, in
  place on the register file;
* ``tile`` (:func:`wavefront_alu`): the TPU kernel's function.
"""
from __future__ import annotations

import torch

from .. import build, egpu_step
from .ref import OPS, TILE_T, fp_step_ref, wavefront_alu_ref

_OP_INDEX = {op: k for k, op in enumerate(OPS)}


def wavefront_alu(a: torch.Tensor, b: torch.Tensor, init: torch.Tensor,
                  active: torch.Tensor, op: str = "add") -> torch.Tensor:
    """``out = active[tile] ? op(a, b) : init`` over ``(T, L)`` float32,
    in tiles of :data:`TILE_T` rows (the last one may be ragged);
    ``active`` is the ``(ceil(T / 8),)`` tile bitmap.  Bit-exact to the
    reference's float32 rules on either device."""
    k = _OP_INDEX.get(op)
    if k is None:
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
    if not (b.device == init.device == active.device == a.device):
        raise ValueError("all operands must be on one device")
    a, b, init = (t if t.is_contiguous() else t.contiguous()
                  for t in (a, b, init))
    if active.dtype != torch.int32 or not active.is_contiguous():
        active = active.to(torch.int32).contiguous()
    out = torch.empty_like(a)
    err = build.entry("wavefront_alu")(
        a.data_ptr(), b.data_ptr(), init.data_ptr(), active.data_ptr(),
        out.data_ptr(), rows, lanes, k, build.stream(a.device))
    wavefront_alu.launches += 1
    wavefront_alu.by_route["tile"] += 1
    build.check(err, "wavefront_alu")
    return out


def fp_step_launcher(regs: torch.Tensor, masks: torch.Tensor, opcodes):
    """The ``step`` route prepared once over a register file on the card
    (:func:`repro_torch.kernels.egpu_step.launcher`): returns
    ``launch(row_ptr, pred_ptr)``, one ctypes call a step."""
    return egpu_step.launcher("wavefront_alu", "egpu_fp_step", wavefront_alu,
                              regs, masks, opcodes)


def fp_step(regs: torch.Tensor, tr: torch.Tensor, masks: torch.Tensor,
            pred, opcodes) -> None:
    """One FP instruction step of a batch of cores, in place (arguments
    as in :mod:`repro_torch.kernels.egpu_step`): each core whose opcode
    is ``opcodes[k]`` sets ``Rd = wm ? OPS[k](Ra, Rb) : Rd``."""
    egpu_step.check(regs, masks, tr, pred)
    if regs.device.type == "cpu":
        fp_step_ref(regs, tr, masks, pred, opcodes)
        return
    egpu_step.check_dense(tr, pred)
    fp_step_launcher(regs, masks, opcodes)(
        tr.data_ptr(), 0 if pred is None else pred.data_ptr())


#: kernel launches made through these wrappers, in all and by route (the
#: CPU path counts none)
wavefront_alu.launches = 0
wavefront_alu.by_route = {"step": 0, "tile": 0}
