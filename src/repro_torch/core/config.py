"""Static scalability: the eGPU configuration space (paper §3, §5).

Every knob here is a configuration-time parameter of the soft processor;
the area/Fmax consequences are modelled in the reference's :mod:`repro.core.area_model`
and validated against Tables 4-6 of the paper.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Pipeline/latency parameters for the cycle cost model.

    The eGPU has an 8-stage pipeline and *no* hazard-tracking hardware
    (paper §3): dependent instructions closer than the producer's latency
    must be separated by NOPs, which the assembler inserts.
    """

    pipe_latency: int = 8        # ALU/FP result latency (8-stage pipe)
    mem_latency: int = 8         # shared-memory load-to-use latency
    dot_latency: int = 24        # DOT/SUM writeback latency ("waiting for
                                 # the dot product to write back", §7)
    invsqr_latency: int = 16     # SFU latency
    sp_read_ports: int = 4       # shared memory read ports (DP and QP)
    # write ports depend on memory_mode: 1 (DP) or 2 (QP)


@dataclasses.dataclass(frozen=True)
class EGPUConfig:
    """One statically-configured eGPU instance."""

    # --- thread space -----------------------------------------------------
    num_sps: int = 16            # wavefront width (fixed at 16 in the paper)
    max_threads: int = 512       # configured thread space
    regs_per_thread: int = 16    # 16 / 32 / 64 in the paper's tables

    # --- memories -----------------------------------------------------------
    shared_kb: int = 8           # shared memory size in KB (32-bit words)
    memory_mode: str = "dp"      # "dp" (1GHz M20K) or "qp" (600MHz, 2 wr ports)

    # --- integer ALU ----------------------------------------------------------
    alu_bits: int = 32           # 16 or 32
    alu_features: str = "full"   # "min" | "small" | "full"  (Table 6)
    shift_bits: int = 32         # 1, 16, or 32 (shift precision)

    # --- predicates -------------------------------------------------------
    predicate_levels: int = 0    # 0 disables predicates entirely

    # --- extension units ------------------------------------------------------
    has_dot: bool = False        # dot-product core
    has_invsqr: bool = False     # reciprocal-sqrt SFU

    # --- sequencer limits ---------------------------------------------------
    max_loop_depth: int = 8
    max_call_depth: int = 8
    max_steps: int = 2_000_000   # executor safety bound (instructions)

    cost: CostParams = dataclasses.field(default_factory=CostParams)

    # -----------------------------------------------------------------------
    def __post_init__(self):
        if self.num_sps != 16:
            raise ValueError("the eGPU wavefront width is 16 SPs")
        if self.max_threads % self.num_sps:
            raise ValueError("max_threads must be a multiple of num_sps")
        if self.memory_mode not in ("dp", "qp"):
            raise ValueError(f"bad memory_mode {self.memory_mode!r}")
        if self.alu_bits not in (16, 32):
            raise ValueError("alu_bits must be 16 or 32")
        if self.shift_bits not in (1, 16, 32):
            raise ValueError("shift_bits must be 1, 16 or 32")
        if self.regs_per_thread not in (8, 16, 32, 64, 128):
            raise ValueError("unsupported regs_per_thread")

    # --- derived quantities -------------------------------------------------
    @property
    def max_wavefronts(self) -> int:
        return self.max_threads // self.num_sps

    @property
    def shared_words(self) -> int:
        return self.shared_kb * 1024 // 4

    @property
    def write_ports(self) -> int:
        return 2 if self.memory_mode == "qp" else 1

    @property
    def fmax_mhz(self) -> float:
        """Paper §6: DP instances close at 771 MHz (DSP-limited); QP at
        600 MHz (QP M20K-limited)."""
        return 600.0 if self.memory_mode == "qp" else 771.0

    @property
    def has_predicates(self) -> bool:
        return self.predicate_levels > 0

    def cycles_to_us(self, cycles) -> float:
        return float(cycles) / self.fmax_mhz

    def replace(self, **kw) -> "EGPUConfig":
        return dataclasses.replace(self, **kw)


# --- The paper's published configurations (Tables 4 and 5) -----------------

def table4_configs() -> dict[str, EGPUConfig]:
    """DP-memory instances of Table 4 (in row order)."""
    return {
        "small_dp_a": EGPUConfig(alu_bits=16, shift_bits=1, max_threads=512,
                                 regs_per_thread=16, shared_kb=8,
                                 predicate_levels=0, alu_features="min"),
        "small_dp_b": EGPUConfig(alu_bits=16, shift_bits=16, max_threads=512,
                                 regs_per_thread=16, shared_kb=32,
                                 predicate_levels=5, alu_features="full"),
        "medium_dp_a": EGPUConfig(alu_bits=16, shift_bits=16, max_threads=512,
                                  regs_per_thread=32, shared_kb=32,
                                  predicate_levels=5, alu_features="full"),
        "medium_dp_b": EGPUConfig(alu_bits=32, shift_bits=16, max_threads=512,
                                  regs_per_thread=32, shared_kb=32,
                                  predicate_levels=5, alu_features="full"),
        "large_dp_a": EGPUConfig(alu_bits=32, shift_bits=16, max_threads=512,
                                 regs_per_thread=64, shared_kb=32,
                                 predicate_levels=8, alu_features="full",
                                 has_dot=True),
        "large_dp_b": EGPUConfig(alu_bits=32, shift_bits=32, max_threads=512,
                                 regs_per_thread=64, shared_kb=64,
                                 predicate_levels=16, alu_features="full",
                                 has_dot=True),
    }


def table5_configs() -> dict[str, EGPUConfig]:
    """QP-memory instances of Table 5 (in row order)."""
    return {
        "small_qp": EGPUConfig(memory_mode="qp", alu_bits=32, shift_bits=1,
                               max_threads=512, regs_per_thread=64,
                               shared_kb=32, predicate_levels=0,
                               alu_features="min"),
        "medium_qp": EGPUConfig(memory_mode="qp", alu_bits=32, shift_bits=32,
                                max_threads=1024, regs_per_thread=32,
                                shared_kb=64, predicate_levels=0,
                                alu_features="full", has_dot=True),
        "large_qp_a": EGPUConfig(memory_mode="qp", alu_bits=32, shift_bits=32,
                                 max_threads=1024, regs_per_thread=32,
                                 shared_kb=64, predicate_levels=16,
                                 alu_features="full", has_dot=True),
        "large_qp_b": EGPUConfig(memory_mode="qp", alu_bits=32, shift_bits=32,
                                 max_threads=1024, regs_per_thread=32,
                                 shared_kb=128, predicate_levels=10,
                                 alu_features="full", has_dot=True),
    }


#: The configuration used for the paper's vector/matrix benchmarks (§7):
#: "32 registers per thread, with a 32 bit ALU, and a 128KB shared memory".
def benchmark_config(memory_mode: str = "dp", *, has_dot: bool = False,
                     predicate_levels: int = 0,
                     max_threads: int = 512) -> EGPUConfig:
    return EGPUConfig(
        max_threads=max_threads,
        regs_per_thread=32,
        shared_kb=128,
        memory_mode=memory_mode,
        alu_bits=32,
        shift_bits=32,
        predicate_levels=predicate_levels,
        has_dot=has_dot,
        has_invsqr=True,
        alu_features="full",
    )
