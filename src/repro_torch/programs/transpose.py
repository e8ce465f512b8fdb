"""Matrix transpose (paper §7, Table 7).

Cycle mechanics per the paper: an n x n transpose needs ~n^2 write
cycles (1 write port, DP) plus n^2/4 read cycles, and the QP variant
"writes two transposed elements per clock" (~40% fewer cycles).
Addresses step incrementally between 512-element chunks: because the
chunk stride (512) is a multiple of n, each thread's column is fixed and
its destination advances by 512/n per chunk — two ADDs per chunk.
"""
from __future__ import annotations

import numpy as np

from ..core.assembler import Asm
from ..core.config import EGPUConfig
from ..core import machine as machine_mod
from .common import Bench, log2i


def build_transpose(cfg: EGPUConfig, n: int) -> Bench:
    t = cfg.max_threads
    if n * n % t:
        raise ValueError("matrix must tile by the thread space")
    chunks = max(1, n * n // t)
    ln = log2i(n)
    dst_base = n * n
    if 2 * n * n > cfg.shared_words:
        raise ValueError("matrix pair does not fit shared memory")

    a = Asm(cfg)
    (R_E, R_ROW, R_COL, R_DST, R_SHIFT, R_MASK, R_V, R_DSTEP, R_SSTEP) = \
        range(1, 10)

    a.tdx(R_E)                     # element index = tid  (tdx_dim = threads)
    a.lodi(R_SHIFT, ln)
    a.lodi(R_MASK, n - 1)
    a.shr(R_ROW, R_E, R_SHIFT)     # row = e >> log2 n
    a.and_(R_COL, R_E, R_MASK)     # col = e & (n-1)
    a.shl(R_DST, R_COL, R_SHIFT)   # dst = col * n
    a.add(R_DST, R_DST, R_ROW)     # dst += row
    a.lodi(R_T := 10, dst_base)
    a.add(R_DST, R_DST, R_T)       # dst += dst_base
    a.lodi(R_SSTEP, t)             # src chunk stride
    a.lodi(R_DSTEP, t >> ln)       # dst chunk stride = 512 / n

    if chunks > 1:
        with a.loop(chunks):
            a.lod(R_V, R_E, 0)
            a.sto(R_V, R_DST, 0)
            a.add(R_E, R_E, R_SSTEP)
            a.add(R_DST, R_DST, R_DSTEP)
    else:
        a.lod(R_V, R_E, 0)
        a.sto(R_V, R_DST, 0)
    a.stop()

    img = a.assemble(threads_active=t)
    rng = np.random.default_rng(n)
    data = rng.standard_normal(n * n).astype(np.float32)

    def oracle(_):
        return data.reshape(n, n).T.ravel()

    def view(st):
        return machine_mod.shared_as_f32(st)[dst_base: dst_base + n * n]

    return Bench(name=f"transpose_{n}_{cfg.memory_mode}", image=img,
                 shared_init=data, oracle=oracle, result_view=view,
                 tdx_dim=t, data_words=2 * n * n)
