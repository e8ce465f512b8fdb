"""Radix-2 DIT FFT (paper §7, Table 8).

One thread per butterfly (n/2 threads).  The input is permuted into a
scratch region using the BVS (bit-reverse) instruction — the reason that
instruction exists in the ISA — then log2(n) in-place butterfly stages
run in scratch.  Twiddle factors are precomputed into shared memory
(there is no trig unit; the paper's kernels do the same).

Layout (32-bit words): re [0,n), im [n,2n), twiddle-re [2n, 2n+n/2),
twiddle-im [2n+n/2, 3n), scratch-re [3n, 4n), scratch-im [4n, 5n).
"""
from __future__ import annotations

import numpy as np

from ..core.assembler import Asm
from ..core.config import EGPUConfig
from ..core import machine as machine_mod
from .common import Bench, log2i


def build_fft(cfg: EGPUConfig, n: int) -> Bench:
    ln = log2i(n)
    threads = max(16, n // 2)
    if threads > cfg.max_threads or 5 * n > cfg.shared_words:
        raise ValueError("FFT size out of range")
    TW_RE, TW_IM = 2 * n, 2 * n + n // 2
    S_RE, S_IM = 3 * n, 4 * n

    a = Asm(cfg)
    (R_TID, R_E, R_REV, R_SH, R_V, R_OFF,
     R_I, R_TW, R_POS, R_GRP, R_DM,
     R_AR, R_AI, R_BR, R_BI, R_WR, R_WI,
     R_M1, R_M2, R_TR, R_TI, R_O) = range(1, 23)

    a.tdx(R_TID)
    # ---- bit-reversal reorder into scratch (2 elements per thread) -------
    a.lodi(R_SH, 32 - ln)
    for off in (0, n // 2):
        a.lodi(R_OFF, off)
        a.add(R_E, R_TID, R_OFF)        # element index
        a.bvs(R_REV, R_E)
        a.shr(R_REV, R_REV, R_SH)       # rev = bitrev(e) >> (32-log2 n)
        a.lod(R_V, R_REV, 0)            # re[rev]
        a.sto(R_V, R_E, S_RE)
        a.lod(R_V, R_REV, n)            # im[rev]
        a.sto(R_V, R_E, S_IM)

    # ---- log2(n) butterfly stages ----------------------------------------
    for s in range(ln):
        d = 1 << s
        a.lodi(R_DM, d - 1)
        a.and_(R_POS, R_TID, R_DM)      # pos = t & (d-1)
        a.lodi(R_SH, s)
        a.shr(R_GRP, R_TID, R_SH)       # grp = t >> s
        a.lodi(R_SH, s + 1)
        a.shl(R_I, R_GRP, R_SH)
        a.add(R_I, R_I, R_POS)          # i = grp*2d + pos   (j = i + d)
        a.lodi(R_SH, ln - 1 - s)
        a.shl(R_TW, R_POS, R_SH)        # twiddle index = pos * n/(2d)
        a.lod(R_AR, R_I, S_RE)
        a.lod(R_AI, R_I, S_IM)
        a.lod(R_BR, R_I, S_RE + d)
        a.lod(R_BI, R_I, S_IM + d)
        a.lod(R_WR, R_TW, TW_RE)
        a.lod(R_WI, R_TW, TW_IM)
        a.fmul(R_M1, R_BR, R_WR)
        a.fmul(R_M2, R_BI, R_WI)
        a.fsub(R_TR, R_M1, R_M2)        # tr = br*wr - bi*wi
        a.fmul(R_M1, R_BR, R_WI)
        a.fmul(R_M2, R_BI, R_WR)
        a.fadd(R_TI, R_M1, R_M2)        # ti = br*wi + bi*wr
        a.fadd(R_O, R_AR, R_TR)
        a.sto(R_O, R_I, S_RE)           # re[i] = ar + tr
        a.fadd(R_O, R_AI, R_TI)
        a.sto(R_O, R_I, S_IM)
        a.fsub(R_O, R_AR, R_TR)
        a.sto(R_O, R_I, S_RE + d)       # re[j] = ar - tr
        a.fsub(R_O, R_AI, R_TI)
        a.sto(R_O, R_I, S_IM + d)
    a.stop()

    img = a.assemble(threads_active=threads)
    rng = np.random.default_rng(n)
    re = rng.standard_normal(n).astype(np.float32)
    im = rng.standard_normal(n).astype(np.float32)
    m = np.arange(n // 2)
    tw_re = np.cos(2 * np.pi * m / n).astype(np.float32)
    tw_im = (-np.sin(2 * np.pi * m / n)).astype(np.float32)
    data = np.concatenate([re, im, tw_re, tw_im,
                           np.zeros(2 * n, np.float32)])

    def oracle(_):
        sp = np.fft.fft(re.astype(np.float64) + 1j * im.astype(np.float64))
        return np.concatenate([sp.real, sp.imag]).astype(np.float32)

    def view(st):
        buf = machine_mod.shared_as_f32(st)
        return np.concatenate([buf[S_RE:S_RE + n], buf[S_IM:S_IM + n]])

    return Bench(name=f"fft_{n}_{cfg.memory_mode}", image=img,
                 shared_init=data, oracle=oracle, result_view=view,
                 tdx_dim=threads, atol=2e-3 * np.sqrt(n), rtol=1e-3,
                 data_words=4 * n)
