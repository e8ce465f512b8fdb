"""Cycle-accurate cost model for the eGPU.

The model follows the paper's microarchitecture:

* the sequencer issues one *wavefront* (16 lanes) per cycle for vector
  (operation) instructions, so an op costs ``active_wavefronts`` cycles;
* shared-memory instructions are port-limited (paper §3.1 / §5.1):
  the DP shared memory has 4 read ports and 1 write port per cycle, the
  QP memory doubles the write ports.  A full-width (16-lane) store
  therefore takes 16 cycles per wavefront in DP mode — which is exactly
  why the paper's dynamic thread-space subsetting ("subset write can be
  16x faster than using the generic write") pays off;
* sequencer-only instructions (branches, loop control, NOP) cost 1 cycle;
* there is no hazard hardware: results have a pipeline latency and the
  assembler inserts NOPs to cover read-after-write hazards
  (:func:`repro_torch.core.assembler.schedule`).

The same integer math is used by the Python-side scheduler and the JAX
executor (the executor re-implements it with jnp scalars — see
``executor._issue_cycles``); ``tests/test_cost.py`` asserts they agree.
"""
from __future__ import annotations

from .config import EGPUConfig
from . import isa
from .isa import Op


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def depth_wavefronts(depth_code: int, runtime_wavefronts: int) -> int:
    """Number of wavefronts issued for a TSC depth code (Table 3)."""
    if depth_code == isa.DEPTH_WF0:
        return 1
    if depth_code == isa.DEPTH_ALL:
        return runtime_wavefronts
    if depth_code == isa.DEPTH_HALF:
        return max(1, _cdiv(runtime_wavefronts, 2))
    return max(1, _cdiv(runtime_wavefronts, 4))


def issue_cycles(op: int, tsc: int, runtime_wavefronts: int,
                 cfg: EGPUConfig) -> int:
    """Cycles the instruction occupies the issue stage."""
    op = Op(op)
    if op in isa.SCALAR_OPS:
        return 1
    width_lanes = isa.WIDTH_LANES[isa.tsc_width(tsc)]
    wfs = depth_wavefronts(isa.tsc_depth(tsc), runtime_wavefronts)
    if op == Op.LOD:
        return wfs * _cdiv(width_lanes, cfg.cost.sp_read_ports)
    if op == Op.STO:
        return wfs * _cdiv(width_lanes, cfg.write_ports)
    # All other vector ops (ALU/FP/predicate/thread/extension reads):
    # one cycle per active wavefront, independent of width.
    return wfs


def result_latency(op: int, cfg: EGPUConfig) -> int:
    """Cycles after the *first* issue cycle until the result is readable.

    Used by the NOP scheduler: a consumer must not start issuing before
    ``producer_start + result_latency``.
    """
    op = Op(op)
    c = cfg.cost
    if op in (Op.DOT, Op.SUM):
        return c.dot_latency
    if op == Op.INVSQR:
        return c.invsqr_latency
    if op == Op.LOD:
        return c.mem_latency
    if op in isa.SCALAR_OPS or op in (Op.STO, Op.ELSE, Op.ENDIF):
        return 0
    return c.pipe_latency


def bus_transfer_cycles(n_words: int) -> int:
    """Loading/unloading over the 32-bit data bus (paper §7: +4.7% avg)."""
    return n_words
