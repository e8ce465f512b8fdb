"""eGPU core on PyTorch: the port of ``repro.core`` (the interpreter, the
blocks and the superblock tiers, and the paper's area model)."""
from .config import (EGPUConfig, CostParams, table4_configs, table5_configs,
                     benchmark_config)
from .isa import (Op, Typ, Instr, OpClass, encode_word, decode_word, iw_bits,
                  TSC_FULL, TSC_WF0, TSC_CPU, TSC_MCU, PERSONALITIES)
from .assembler import Asm, ProgramImage, schedule
from .machine import (MachineState, init_state, shared_as_f32, shared_as_u32,
                      shared_as_i32, profile, state_from_numpy,
                      state_to_numpy)
from .executor import make_step, pad_image, run_program
from .blockc import (DEFAULT_TIER_POLICY, BlockCompileError, CompiledProgram,
                     TierPolicy, compile_program, run_compiled)
from .area_model import resources, Resources
from . import cost, area_model, semantics

__all__ = [
    "EGPUConfig", "CostParams", "table4_configs", "table5_configs",
    "benchmark_config", "Op", "Typ", "Instr", "OpClass", "encode_word",
    "decode_word", "iw_bits", "TSC_FULL", "TSC_WF0", "TSC_CPU", "TSC_MCU",
    "PERSONALITIES", "Asm", "ProgramImage", "schedule", "MachineState",
    "init_state", "shared_as_f32", "shared_as_u32", "shared_as_i32",
    "profile", "state_from_numpy", "state_to_numpy", "run_program",
    "make_step", "pad_image", "resources", "Resources", "cost",
    "area_model", "semantics", "BlockCompileError",
    "CompiledProgram", "compile_program", "run_compiled", "TierPolicy",
    "DEFAULT_TIER_POLICY",
]
