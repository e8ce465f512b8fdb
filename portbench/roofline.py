"""Peaks of the card and the work the eGPU step kernels must do.

A kernel's roofline share is the least time the card could take for the
work, the larger of its operations over the float32 peak and its bytes
over the memory bandwidth, over the time the kernel took.  The work is
what the job's inputs need, from the shapes of each launch: every
operand a thread with its mask set reads, every result it writes, the
mask byte of each thread and the instruction row, each counted once.
The arithmetic is ``chip_smoke.py``'s step-route bound, with the active
threads of each launch in place of the whole thread space.
"""
from __future__ import annotations

import numpy as np

from .reference import egpu

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 outside the
#: tensor cores (dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
ROW_BYTES = 7 * 8                        # one int64 trace row


def fp_step_work(cores: int, active: int, threads: int) -> tuple:
    """``(operations, bytes)`` of one FP step launch over ``cores``
    cores: ``Ra`` and ``Rb`` read and ``Rd`` written by each of its
    ``active`` threads, one mask byte a thread, the row."""
    return (cores * active,
            cores * (12 * active + threads + ROW_BYTES))


def ext_step_work(cores: int, active: int, threads: int) -> tuple:
    """``(operations, bytes)`` of one DOT/SUM step launch: a multiply
    and an add a thread with its mask set, ``Ra`` and ``Rb`` read, one
    mask byte a thread, the row, thread 0's ``Rd`` written."""
    return (cores * 2 * active,
            cores * (8 * active + threads + ROW_BYTES + 4))


def min_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_S, nbytes / PEAK_BYTES_S)


def path_work(core: egpu.Core, path: egpu.Path, threads: int,
              cores: int) -> dict:
    """``{kernel: (launches, least seconds)}`` of one run of a program's
    path over ``cores`` lock-step cores: one ``wavefront_alu`` launch a
    FADD/FSUB/FMUL/FMAX/FMIN step, one ``dot_product`` launch a DOT/SUM
    step (no predicates in these paths, so the TSC mask is the mask)."""
    masks = egpu.tsc_masks(core, threads).sum(1)
    out = {"wavefront_alu": [0, 0.0], "dot_product": [0, 0.0]}
    T = core.max_threads
    for op, tsc in zip(path.rows[:, 0].tolist(), path.rows[:, 6].tolist()):
        if op in egpu.FP_BINARY:
            k, work = "wavefront_alu", fp_step_work(cores, int(masks[tsc]), T)
        elif op in (egpu.OP["DOT"], egpu.OP["SUM"]):
            k, work = "dot_product", ext_step_work(cores, int(masks[tsc]), T)
        else:
            continue
        out[k][0] += 1
        out[k][1] += min_seconds(*work)
    return {k: tuple(v) for k, v in out.items()}


def share(least_s: float, launches_expected: int, measured: tuple):
    """Percent of the roofline from the least time of the expected
    launches and the profiler's ``(seconds, launches)``; ``None`` when
    the profile holds none.  Where the profiler dropped launches, the
    least time is scaled to the launches it kept."""
    secs, n = measured
    if not n or not launches_expected or secs <= 0:
        return None
    return 100.0 * least_s * (n / launches_expected) / secs


def summed(works: list) -> tuple:
    """``(launches, least seconds)`` of a list of ``path_work`` values
    of one kernel."""
    return (int(np.sum([w[0] for w in works])),
            float(np.sum([w[1] for w in works])))
