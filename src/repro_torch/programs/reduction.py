"""Vector reduction (paper §7, Table 7).

The showcase for *dynamic scalability*: the tree reduction narrows every
step, and the TSC field narrows the issued thread space with it — the
final steps run as "multithreaded CPU" / "MCU" personalities, exactly as
described in the paper ("All final vector reductions end up in the first
SP, and we can use the multi-threaded CPU or MCU eGPU dynamic scaling
personalities to write these values to the shared memory").

Variants:
  * plain        — TSC-subset tree (the paper's eGPU-DP/QP columns)
  * use_dot      — the SUM extension unit (the paper's eGPU-Dot column)
  * no_dynamic   — ablation: full-width issue with predicate masking
                   (what a conventional SIMT core without the paper's
                   dynamic thread-space control would do)
"""
from __future__ import annotations

import numpy as np

from ..core import isa
from ..core.assembler import Asm
from ..core.config import EGPUConfig
from ..core import machine as machine_mod
from .common import Bench


def _strides(n: int):
    s = n // 2
    while s >= 1:
        yield s
        s //= 2


def _tsc_for_stride(s: int, n: int):
    """Pick the cheapest TSC coding whose active set covers threads < s.

    Wavefront-level strides use depth codes; sub-wavefront strides use
    width codes (over-wide writes only touch lanes >= s, which later steps
    never read — see the 'garbage tail' argument in tests).
    """
    wfs = n // 16
    if s >= 16:
        need = s // 16
        if need == wfs:
            return isa.TSC_FULL
        if 2 * need == wfs:
            return (isa.WIDTH_ALL, isa.DEPTH_HALF)
        if 4 * need == wfs:
            return (isa.WIDTH_ALL, isa.DEPTH_QUARTER)
        return (isa.WIDTH_ALL, isa.DEPTH_WF0) if need == 1 else isa.TSC_FULL
    if s > 4:
        return (isa.WIDTH_ALL, isa.DEPTH_WF0)      # 16 lanes, garbage tail
    if s > 1:
        return (isa.WIDTH_QUARTER, isa.DEPTH_WF0)  # 4 lanes
    return (isa.WIDTH_ONE, isa.DEPTH_WF0)          # MCU


def build_reduction(cfg: EGPUConfig, n: int, *, use_dot: bool = False,
                    no_dynamic: bool = False,
                    multi_load: bool = False) -> Bench:
    """``multi_load`` (§Perf, beyond-paper): for large n each thread folds
    ``fold`` elements with LOD-offset immediates before the TSC tree, so
    the tree depth stops growing with n (fixes the 1.45x blow-up at
    n=128 vs the paper's flat scaling)."""
    if n % 16 or (not multi_load and n > cfg.max_threads):
        raise ValueError(f"n={n} must be a multiple of 16 <= {cfg.max_threads}")
    a = Asm(cfg)
    R_TID, R_ACC, R_T, R_S, R_OUT = 1, 2, 3, 4, 5

    n_elems = n
    fold = 4 if (multi_load and n >= 64) else 1
    threads = max(16, n // fold)
    a.tdx(R_TID)                       # tid (tdx_dim == threads)
    a.lod(R_ACC, R_TID, 0)             # acc = x[tid]
    for j in range(1, fold):
        a.lod(R_T, R_TID, j * threads)
        a.fadd(R_ACC, R_ACC, R_T)
    if fold > 1:
        a.sto(R_ACC, R_TID, 0)         # partials into x[0:threads]
        n = threads                    # tree runs over the partials

    if use_dot:
        a.sum_(R_OUT, R_ACC)           # thread0.R_OUT = sum over thread space
        a.lodi(R_TID, 0, tsc="mcu")
        a.sto(R_OUT, R_TID, 0, tsc="mcu")   # x[0] = result (1-cycle write)
    elif no_dynamic:
        # conventional SIMT: full-width issue, predicate-masked writeback
        if not cfg.has_predicates:
            raise ValueError("no_dynamic ablation needs predicates")
        for s in _strides(n):
            a.lodi(R_S, s)
            a.if_("lt", R_TID, R_S, typ=isa.Typ.U32)   # only t < s writes
            a.lod(R_T, R_TID, s)       # x[t + s]
            a.fadd(R_ACC, R_ACC, R_T)
            a.sto(R_ACC, R_TID, 0)     # full-width store, masked writeback
            a.endif()
    else:
        for s in _strides(n):
            tsc = _tsc_for_stride(s, n)
            a.lod(R_T, R_TID, s, tsc=tsc)
            a.fadd(R_ACC, R_ACC, R_T, tsc=tsc)
            a.sto(R_ACC, R_TID, 0, tsc=tsc)
    a.stop()

    img = a.assemble(threads_active=max(16, n))
    rng = np.random.default_rng(n_elems)
    data = rng.standard_normal(n_elems).astype(np.float32)

    def oracle(_):
        return np.array([data.sum()], dtype=np.float32)

    def view(st):
        return machine_mod.shared_as_f32(st)[:1]

    name = f"reduction{'_dot' if use_dot else ''}" \
           f"{'_nodyn' if no_dynamic else ''}" \
           f"{'_mload' if fold > 1 else ''}_{n_elems}_{cfg.memory_mode}"
    return Bench(name=name, image=img, shared_init=data, oracle=oracle,
                 result_view=view, tdx_dim=n, atol=1e-3 * n_elems,
                 data_words=n_elems + 1)
