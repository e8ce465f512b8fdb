"""Bitonic sort (paper §7, Table 8) — requires predicates.

Per-pass logic (one thread per element, Batcher's network unrolled, which
matches the paper's ~250-instruction program for 256 elements): each
thread keeps MIN or MAX of its pair depending on whether it is the lower
partner XNOR the block direction — selected with the predicate stack
(IF/ELSE/ENDIF), the feature whose ~50% area cost the paper highlights.
"""
from __future__ import annotations

import numpy as np

from ..core import isa
from ..core.assembler import Asm
from ..core.config import EGPUConfig
from ..core import machine as machine_mod
from .common import Bench, log2i


def build_bitonic(cfg: EGPUConfig, n: int) -> Bench:
    if not cfg.has_predicates:
        raise ValueError("bitonic sort requires predicates (paper §7)")
    if n % 16 or n > cfg.max_threads:
        raise ValueError("n must be a multiple of 16 within the thread space")
    log2i(n)  # power-of-two check

    a = Asm(cfg)
    (R_TID, R_J, R_K, R_P, R_V, R_PV, R_TJ, R_TK, R_OUT) = range(1, 10)
    a.tdx(R_TID)
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            a.lodi(R_J, j)
            a.lodi(R_K, k)
            a.xor(R_P, R_TID, R_J)          # partner index
            a.lod(R_V, R_TID, 0)
            a.lod(R_PV, R_P, 0)
            a.and_(R_TJ, R_TID, R_J)
            a.and_(R_TK, R_TID, R_K)
            a.cnot(R_TJ, R_TJ)              # 1 iff lower partner
            a.cnot(R_TK, R_TK)              # 1 iff ascending block
            a.if_("eq", R_TJ, R_TK)         # lower==asc -> keep MIN
            a.min_(R_OUT, R_V, R_PV, typ=isa.Typ.I32)
            a.else_()
            a.max_(R_OUT, R_V, R_PV, typ=isa.Typ.I32)
            a.endif()
            a.sto(R_OUT, R_TID, 0)
            j //= 2
        k *= 2
    a.stop()

    img = a.assemble(threads_active=n)
    rng = np.random.default_rng(n)
    data = rng.integers(-(2**30), 2**30, size=n, dtype=np.int32)

    def oracle(_):
        return np.sort(data)

    def view(st):
        return machine_mod.shared_as_i32(st)[:n]

    return Bench(name=f"bitonic_{n}_{cfg.memory_mode}", image=img,
                 shared_init=data.view(np.uint32), oracle=oracle,
                 result_view=view, tdx_dim=n, data_words=2 * n)
