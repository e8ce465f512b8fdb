"""Plain PyTorch versions of the wavefront ALU kernels (exact on any
device).

:func:`wavefront_alu_ref` mirrors ``repro/kernels/wavefront_alu/ref.py``
but works on the float32 *bit patterns*, with the reference's x86 rules
made explicit (:mod:`repro_torch.kernels.fp32`), and it masks a ragged
last tile instead of requiring ``T % 8 == 0``.  :func:`fp_step_ref` is
the step form that the eGPU main path runs: a whole FP instruction step
of a batch of cores, in place on the register file.
"""
from __future__ import annotations

import torch

from .. import egpu_step, fp32

OPS = ("add", "sub", "mul", "max", "min")
TILE_T = 8


def tile_mask(active: torch.Tensor, rows: int, tile: int = TILE_T):
    """Per-row flag from the per-tile activity bitmap ``(ceil(rows/tile),)``."""
    return torch.repeat_interleave(active != 0, tile)[:rows]


def wavefront_alu_ref(a: torch.Tensor, b: torch.Tensor, init: torch.Tensor,
                      active: torch.Tensor, op: str,
                      tile: int = TILE_T) -> torch.Tensor:
    """``op`` over the rows of active tiles; inactive tiles keep ``init``
    bit for bit.  ``a, b, init``: ``(T, L)`` float32; ``active``:
    ``(ceil(T / tile),)`` int32 or bool."""
    f = fp32.BINARY[op]
    out = f(fp32.as_bits(a), fp32.as_bits(b))
    keep = tile_mask(active, a.shape[0], tile)[:, None]
    return fp32.as_f32(torch.where(keep, out, fp32.as_bits(init)))


def fp_step_ref(regs: torch.Tensor, tr: torch.Tensor, masks: torch.Tensor,
                pred, opcodes) -> None:
    """One FP instruction step, in place (arguments as in
    :mod:`repro_torch.kernels.egpu_step`): each core whose opcode is
    ``opcodes[k]`` sets ``Rd = wm ? OPS[k](Ra, Rb) : Rd`` with ``wm =
    masks[tsc] & pred``; every other core is left as it is.  A tile's
    activity changes no bit here (an inactive tile keeps ``init``, which
    is Rd), so the plain version has no tiles."""
    op = tr[:, egpu_step.ROW_OP, None]
    ra = egpu_step.operand(regs, tr, egpu_step.ROW_RA)
    rb = egpu_step.operand(regs, tr, egpu_step.ROW_RB)
    out = egpu_step.operand(regs, tr, egpu_step.ROW_RD)
    wm = egpu_step.write_mask(masks, tr, pred)
    for k, name in enumerate(OPS):
        on = wm & (op == opcodes[k])
        if bool(on.any()):
            out = torch.where(on, fp32.BINARY[name](ra, rb), out)
    B, T, _ = regs.shape
    regs.scatter_(2, tr[:, None, egpu_step.ROW_RD:egpu_step.ROW_RD + 1]
                  .expand(B, T, 1), out[..., None])
