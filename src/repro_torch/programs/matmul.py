"""Matrix-matrix multiply (paper §7, Table 7).

Two implementations, as in the paper:

* plain  — one thread per output element, k-loop in registers; C
  overwrites A row-blocks as they die (this is how the paper fits
  128x128 in a 128KB shared memory);
* use_dot — the dot-product extension computes a whole <a-row, b-col>
  inner product per issue; results collect in SP0 and are written back
  with 1-cycle MCU-personality stores (dynamic scalability), software-
  pipelined 8 DOTs deep to hide the unit's writeback latency.
"""
from __future__ import annotations

import numpy as np

from ..core.assembler import Asm
from ..core.config import EGPUConfig
from ..core import machine as machine_mod
from .common import Bench, log2i


def build_matmul(cfg: EGPUConfig, n: int, *, use_dot: bool = False) -> Bench:
    t = cfg.max_threads
    ln = log2i(n)
    if 2 * n * n > cfg.shared_words:
        raise ValueError("A+B do not fit shared memory")

    a = Asm(cfg)
    if not use_dot:
        rpp = t // n
        passes = n // rpp
        (R_J, R_IL, R_IG, R_PB, R_A, R_B, R_AV, R_BV, R_P, R_ACC, R_ONE,
         R_N, R_SH, R_C, R_RPP) = range(1, 16)
        a.tdx(R_J)
        a.tdy(R_IL)
        a.lodi(R_PB, 0)
        a.lodi(R_ONE, 1)
        a.lodi(R_N, n)
        a.lodi(R_SH, ln)
        a.lodi(R_RPP, rpp)
        with a.loop(passes):
            a.add(R_IG, R_IL, R_PB)
            a.shl(R_A, R_IG, R_SH)
            a.add(R_C, R_A, R_J)
            a.or_(R_B, R_J, R_J)        # b addr = j (register copy)
            a.lodi(R_ACC, 0)
            with a.loop(n):
                a.lod(R_AV, R_A, 0)
                a.lod(R_BV, R_B, n * n)
                a.fmul(R_P, R_AV, R_BV)
                a.fadd(R_ACC, R_ACC, R_P)
                a.add(R_A, R_A, R_ONE)
                a.add(R_B, R_B, R_N)
            a.sto(R_ACC, R_C, 0)
            a.add(R_PB, R_PB, R_RPP)
        threads = t
        tdx_dim = n
    else:
        # threads span the k dimension; DOT folds a whole inner product.
        (R_K, R_A, R_B, R_BV, R_AROW, R_N, R_SH, R_C) = range(1, 9)
        DOT_REGS = list(range(16, 24))      # 8-deep software pipeline
        groups = n // len(DOT_REGS)
        a.tdx(R_K)                          # k  (tdx_dim = n)
        a.lodi(R_N, n)
        a.lodi(R_SH, ln)
        a.add(R_A, R_K, 0)                  # a addr = 0*n + k
        a.lodi(R_C, 0, tsc="mcu")           # C writeback cursor (SP0)
        with a.loop(n):                     # rows i
            a.lod(R_AROW, R_A, 0)           # a[i, :] across threads
            a.shl(R_B, R_K, R_SH)           # b addr = k*n (+j below)
            with a.loop(groups):            # 8-column groups
                for g, rdot in enumerate(DOT_REGS):
                    a.lod(R_BV, R_B, n * n + g)   # b[k, j+g]
                    a.dot(rdot, R_AROW, R_BV)
                for g, rdot in enumerate(DOT_REGS):
                    a.sto(rdot, R_C, g, tsc="mcu")   # 1-cycle subset writes
                a.lodi(R_BV, len(DOT_REGS))
                a.add(R_B, R_B, R_BV)
                a.add(R_C, R_C, R_BV, tsc="mcu")
            a.add(R_A, R_A, R_N)
        threads = n
        tdx_dim = n
    a.stop()

    img = a.assemble(threads_active=threads)
    rng = np.random.default_rng(n)
    A = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    B = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    data = np.concatenate([A.ravel(), B.ravel()])

    def oracle(_):
        return (A @ B).ravel()

    def view(st):
        return machine_mod.shared_as_f32(st)[: n * n]   # C overwrote A

    name = f"matmul{'_dot' if use_dot else ''}_{n}_{cfg.memory_mode}"
    return Bench(name=name, image=img, shared_init=data, oracle=oracle,
                 result_view=view, tdx_dim=tdx_dim, atol=5e-3, rtol=5e-3,
                 data_words=3 * n * n)
