"""The host side of the eGPU step kernels, shared by their two wrappers
(``wavefront_alu.ops.fp_step``, ``dot_product.ops.ext_step``).

A step kernel runs one whole instruction step of a batch of eGPU cores
in place on the register file.  Its arguments:

* ``regs`` ``(B, T, R)`` int32: the register file, float32 bit patterns;
* ``tr`` ``(B, 7)`` int64: this step's row of the instruction trace for
  each core, columns ``op, typ, rd, ra, rb, imm, tsc`` (a core that does
  not run the kernel's opcodes this step is left untouched);
* ``masks`` ``(B, 16, T)`` bool: each core's TSC thread masks;
* ``pred`` ``(B, T)`` bool: the predicate mask in force when the step
  began, or ``None`` when no core has a predicate pushed;
* ``opcodes``: the eGPU opcode of each of the kernel's operations, in
  the kernel's order (packed one byte each for the CUDA entry).
"""
from __future__ import annotations

import torch

from . import build

#: trace row columns (``core.executor.PROG_FIELDS``)
ROW_OP, ROW_RD, ROW_RA, ROW_RB, ROW_TSC = 0, 2, 3, 4, 6
ROW_LEN = 7
TSC_CODES = 16
WAVEFRONT = 16                          # the eGPU's SPs: lanes a wavefront


def pack_opcodes(opcodes) -> int:
    """Byte ``k`` holds the opcode of operation ``k`` (``egpu::step_op``)."""
    out = 0
    for k, op in enumerate(opcodes):
        if not 0 <= op < 256:
            raise ValueError(f"opcode {op} does not fit a byte")
        out |= int(op) << (8 * k)
    return out


def check(regs, masks, tr=None, pred=None) -> None:
    """Shapes, dtypes and devices of a step's arguments (``tr`` and
    ``pred`` when given)."""
    if regs.dtype != torch.int32 or regs.dim() != 3:
        raise TypeError("regs must be a (B, T, R) int32 register file")
    B, T, _ = regs.shape
    if T % WAVEFRONT:
        raise ValueError(f"the thread count must be a multiple of {WAVEFRONT}")
    if masks.dtype != torch.bool or masks.shape != (B, TSC_CODES, T):
        raise ValueError(f"masks must be ({B}, {TSC_CODES}, {T}) bool")
    if tr is not None and (tr.dtype != torch.int64
                           or tr.shape != (B, ROW_LEN)):
        raise ValueError(f"the trace row must be ({B}, {ROW_LEN}) int64")
    if pred is not None and (pred.dtype != torch.bool
                             or pred.shape != (B, T)):
        raise ValueError(f"pred must be ({B}, {T}) bool")
    for t in (masks, tr, pred):
        if t is not None and t.device != regs.device:
            raise ValueError("all operands must be on one device")


def check_dense(*ts) -> None:
    """The CUDA entries take raw pointers: every tensor must be dense."""
    for t in ts:
        if t is not None and not t.is_contiguous():
            raise ValueError("the step kernels take contiguous tensors")


def operand(regs, tr, field: int) -> torch.Tensor:
    """Register ``tr[:, field]`` of every thread of each core: ``(B, T)``."""
    B, T, _ = regs.shape
    return regs.gather(2, tr[:, None, field:field + 1].expand(B, T, 1))[..., 0]


def write_mask(masks, tr, pred) -> torch.Tensor:
    """``masks[b, tsc_b] & pred[b]``: ``(B, T)``."""
    m = masks[torch.arange(masks.shape[0], device=masks.device),
              tr[:, ROW_TSC]]
    return m if pred is None else m & pred


def launcher(kernel, sym: str, counter, regs, masks, opcodes):
    """Prepare a step entry over one register file on the card: the
    checks, the entry point, the stream and the pointers of ``regs`` and
    ``masks`` are taken here, once.  Returns ``launch(row_ptr,
    pred_ptr)``: one ctypes call with this step's trace row address and
    the predicate mask's pointer (0 for none), counted on ``counter``
    (``launches`` and ``by_route["step"]``)."""
    check(regs, masks)
    check_dense(regs, masks)
    if regs.device.type != "cuda":
        raise RuntimeError(f"no {kernel} step kernel for {regs.device}")
    fn = build.entry(kernel, sym)
    B, T, R = regs.shape
    regs_p, masks_p = regs.data_ptr(), masks.data_ptr()
    packed, stream = pack_opcodes(opcodes), build.stream(regs.device)

    def launch(row_ptr: int, pred_ptr: int) -> None:
        err = fn(regs_p, row_ptr, masks_p, pred_ptr, packed, B, T, R, stream)
        counter.launches += 1
        counter.by_route["step"] += 1
        if err:
            build.check(err, f"{kernel} step")

    return launch
