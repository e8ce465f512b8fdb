"""Plain PyTorch version of the DOT/SUM extension kernel (exact on any
device).

Unlike ``repro/kernels/dot_product/ref.py`` (``jnp.sum``, any order) the
order is fixed to the reference's ``det_sum`` (``semantics.py``): each
lane accumulates its rows in order, starting from the first active row's
product, then the lanes are reduced by the halving tree
``acc[:s] + acc[s:2s]``; every multiply and add follows the reference's
x86 rules (:mod:`repro_torch.kernels.fp32`).  With 16 lanes the result
is bit-identical to ``det_sum``.  :func:`ext_step_ref` is the step form
that the eGPU main path runs: a whole DOT/SUM instruction step of a batch
of cores, in place on the register file.
"""
from __future__ import annotations

import torch

from .. import egpu_step, fp32

TILE_T = 8
#: the step form's operations, in the order of its ``opcodes``
EXT_OPS = ("dot", "sum")
ONE = 0x3F800000                        # 1.0f: SUM's second operand


def upcast_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 or bfloat16 -> float32 bit patterns (the upcast is exact)."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).to(torch.int32) << 16
    return fp32.as_bits(x)


def dot_product_ref(a: torch.Tensor, b: torch.Tensor, active: torch.Tensor,
                    tile: int = TILE_T) -> torch.Tensor:
    """``<a, b>`` over the active tiles, one sum per leading batch entry.

    ``a, b``: ``(T, L)`` or ``(B, T, L)``; ``active``: ``(ceil(T/tile),)``
    or ``(B, ceil(T/tile))``.  Returns a float32 scalar or ``(B,)``; a
    batch entry with no active tile sums to +0.
    """
    single = a.dim() == 2
    if single:
        a, b, active = a[None], b[None], active[None]
    ab, bb = upcast_bits(a), upcast_bits(b)
    B, T, L = ab.shape
    acc = torch.zeros((B, L), dtype=torch.int32, device=a.device)
    started = torch.zeros((B, 1), dtype=torch.bool, device=a.device)
    on = active != 0
    prod = fp32.mul(ab, bb)                 # every product is independent
    for r in range(T):
        act = on[:, r // tile, None]
        p = prod[:, r]
        acc = torch.where(act, torch.where(started, fp32.add(acc, p), p), acc)
        started = started | act
    s = L // 2
    while s >= 1:
        acc = fp32.add(acc[:, :s], acc[:, s:2 * s])
        s //= 2
    out = fp32.as_f32(acc[:, 0].contiguous())
    return out[0] if single else out


def ext_step_ref(regs: torch.Tensor, tr: torch.Tensor, masks: torch.Tensor,
                 pred, opcodes) -> None:
    """One DOT/SUM instruction step, in place (arguments as in
    :mod:`repro_torch.kernels.egpu_step`; ``opcodes`` = DOT's, SUM's):
    each core that runs one writes thread 0's Rd, whatever thread 0's
    mask, with ``det_sum(a * b)`` over all its threads, ``a = wm ? Ra :
    +0``, ``b = wm ? Rb : +0`` for DOT and ``1.0`` for SUM, ``wm =
    masks[tsc] & pred``; every other core is left as it is."""
    op = tr[:, egpu_step.ROW_OP]
    is_dot = op == opcodes[0]
    on = is_dot | (op == opcodes[1])
    wm = egpu_step.write_mask(masks, tr, pred)
    a = torch.where(wm, egpu_step.operand(regs, tr, egpu_step.ROW_RA), 0)
    b = torch.where(is_dot[:, None] & wm,
                    egpu_step.operand(regs, tr, egpu_step.ROW_RB), 0)
    b = torch.where(is_dot[:, None], b, ONE)
    s = fp32.det_sum(fp32.mul(a, b))
    r0 = regs[:, 0]                     # thread 0's registers, a view
    rd = tr[:, egpu_step.ROW_RD, None]
    r0.scatter_(1, rd, torch.where(on, s, r0.gather(1, rd)[:, 0])[:, None])
