"""Resource (ALM / FF / DSP / M20K) and Fmax model — paper §5 & §6
(a copy of the reference's framework-free ``repro.core.area_model``).

The M20K and DSP counts follow the paper's exact formulas (§5.5) and
reproduce Tables 4/5 to the block.  The ALM/FF counts use the paper's
per-component figures (Table 6 ALUs, ~150 ALM SP mux/control, ~250 ALM
sequencer, ~5 ALM/thread predicates) with coefficients fitted to Tables
4/5; `benchmarks/table_area.py` prints the model-vs-paper error per row
(within ~±12% ALMs, ±5% FFs, exact DSP/M20K).
"""
from __future__ import annotations

import dataclasses
import math

from .config import EGPUConfig
from .isa import iw_bits


#: Table 6 — integer ALU (ALMs, FFs) by (precision, feature set).
#: "small" = arith + logic + shifts; "full" adds popcount/max/min etc.
ALU_TABLE = {
    (16, "min"): (90, 136),
    (16, "small"): (134, 207),
    (16, "full"): (199, 269),
    (32, "min"): (208, 406),
    (32, "small"): (300, 550),   # interpolated; paper lists min/full for 32
    (32, "full"): (394, 704),
}

SP_MUX_ALM = 150          # §5.5 "SP overhead (mux and control) ~150 ALMs"
CONTROL_ALM = 250         # §5.4 fetch/decode/control 200-250 ALMs
DOT_CORE_ALM = 200        # dot-product core soft logic (adder tree control)
M20K_GLUE_ALM = 1.5       # column-interface/addressing glue per M20K
PRED_ALM_PER_THREAD = 2.2   # base stack+control, amortised (fit to Tab. 4)
PRED_ALM_PER_LEVEL = 0.15   # "incremental cost of one level ... trivial"
SP_PIPE_FF = 550          # SP pipeline wrapper FFs (fit)
SP_LANE_FF = 6            # per-resident-thread FFs (fit)

DSP_FP_PER_SP = 1         # FP32 mult-add datapath (§5.2)
DSP_INTMUL_PER_2SP = 1    # integer multiplier shared per SP pair (Fig. 5)
DSP_DOT_CORE = 8          # dot-product tree

DEFAULT_PROGRAM_WORDS = 1024   # §5.4 example program space


@dataclasses.dataclass(frozen=True)
class Resources:
    alms: int
    ffs: int
    dsps: int
    m20ks: int
    fmax_mhz: float        # design Fmax (embedded-feature limited)
    soft_fmax_mhz: float   # slowest path outside DSP/M20K (reported in Tab.4)

    @property
    def normalized_cost(self) -> int:
        """Paper §7: cost = ALMs + 100 x DSPs."""
        return self.alms + 100 * self.dsps


def m20k_registers(cfg: EGPUConfig) -> int:
    """§5.5: DP reg M20Ks = threads x regs / 256; QP halves this unless the
    register space is below the QP minimum (threads x regs / 16 <= 2047)."""
    dp = math.ceil(cfg.max_threads * cfg.regs_per_thread / 256)
    if cfg.memory_mode == "qp":
        if cfg.max_threads * cfg.regs_per_thread / 16 > 2047:
            return dp // 2
        return dp
    return dp


def m20k_shared(cfg: EGPUConfig) -> int:
    """§5.5: DP shared-memory M20Ks = 2 x size(KB); QP halves this."""
    dp = 2 * cfg.shared_kb
    return dp // 2 if cfg.memory_mode == "qp" else dp


def m20k_instructions(cfg: EGPUConfig,
                      program_words: int = DEFAULT_PROGRAM_WORDS) -> int:
    """§5.4: one M20K per 512 (<=40-bit) IWs; wider IWs add one x8-format
    M20K per 2k instructions."""
    base = math.ceil(program_words / 512)
    extra = math.ceil(program_words / 2048) if iw_bits(cfg.regs_per_thread) > 40 else 0
    return base + extra


def resources(cfg: EGPUConfig,
              program_words: int = DEFAULT_PROGRAM_WORDS) -> Resources:
    n_sp = cfg.num_sps
    threads_per_sp = cfg.max_threads // n_sp

    alu_alm, alu_ff = ALU_TABLE[(cfg.alu_bits, cfg.alu_features)]
    if cfg.memory_mode == "qp" and cfg.alu_bits == 32 \
            and cfg.alu_features == "full":
        # §5.2: the QP eGPU (600 MHz target) uses the 4-stage 32-bit ALU,
        # "about the size of the 16-bit full function ALU"
        alu_alm, alu_ff = ALU_TABLE[(16, "full")]
        alu_ff = int(alu_ff * 1.6)   # wider datapath keeps more pipe FFs
    pred_alm = 0.0
    pred_ff = 0
    if cfg.has_predicates:
        per_thread = PRED_ALM_PER_THREAD + PRED_ALM_PER_LEVEL * cfg.predicate_levels
        pred_alm = per_thread * threads_per_sp
        pred_ff = cfg.max_threads * cfg.predicate_levels

    m20ks = (m20k_registers(cfg) + m20k_shared(cfg)
             + m20k_instructions(cfg, program_words))

    alms = (CONTROL_ALM
            + n_sp * (SP_MUX_ALM + alu_alm + pred_alm)
            + (DOT_CORE_ALM if cfg.has_dot else 0)
            + M20K_GLUE_ALM * m20ks)

    ffs = n_sp * (alu_ff + SP_PIPE_FF + SP_LANE_FF * threads_per_sp) + pred_ff

    dsps = n_sp * DSP_FP_PER_SP + (n_sp // 2) * DSP_INTMUL_PER_2SP
    if cfg.has_dot:
        dsps += DSP_DOT_CORE

    # Fmax: always embedded-feature limited (§6); the soft-logic path is an
    # empirical fit to the "Freq" column of Tables 4/5.
    soft = 1050.0 - 0.015 * alms
    if cfg.memory_mode == "qp":
        soft -= 60.0   # 4-stage (not 5) integer ALU pipeline (§5.2)
    return Resources(alms=round(alms), ffs=round(ffs), dsps=dsps,
                     m20ks=m20ks, fmax_mhz=cfg.fmax_mhz,
                     soft_fmax_mhz=round(soft))


#: Paper-reported rows for validation: (config-name -> (ALM, FF, DSP, M20K,
#: soft-Fmax, design-Fmax)).  Tables 4 and 5.
PAPER_TABLE4 = {
    "small_dp_a": (4243, 13635, 24, 50, 1018, 771),
    "small_dp_b": (7518, 18992, 24, 98, 898, 771),
    "medium_dp_a": (7579, 19155, 24, 131, 883, 771),
    "medium_dp_b": (9754, 25425, 24, 131, 902, 771),
    "large_dp_a": (10127, 26040, 32, 195, 860, 771),
    "large_dp_b": (10697, 26618, 32, 259, 841, 771),
}
PAPER_TABLE5 = {
    "small_qp": (5468, 14487, 24, 98, 840, 600),
    "medium_qp": (7057, 16722, 32, 131, 763, 600),
    "large_qp_a": (11314, 25050, 32, 131, 763, 600),
    "large_qp_b": (10174, 23094, 32, 195, 714, 600),
}

#: §7: Nios II/e comparison core and the DSP-cost normalisation.
NIOS_ALMS = 1100
NIOS_DSPS = 3
NIOS_FMAX_MHZ = 347.0
DSP_ALM_EQUIV = 100
