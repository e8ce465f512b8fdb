"""Assigned architecture configs (exact values from the public pool) plus
the paper's own eGPU configurations.

``get(name)`` returns the full ModelConfig; ``get_smoke(name)`` returns a
reduced same-family config for CPU smoke tests; ``SHAPES`` defines the
four input-shape cells and ``cells()`` enumerates the 40-cell dry-run
matrix (with the documented long_500k skips).
"""
from __future__ import annotations

import dataclasses
import importlib

ARCHS = [
    "zamba2_1p2b", "qwen3_moe_30b_a3b", "granite_moe_3b_a800m", "yi_9b",
    "phi3_medium_14b", "llama3_405b", "minitron_4b",
    "seamless_m4t_large_v2", "xlstm_350m", "internvl2_2b",
]

#: CLI ids (--arch <id>) -> module names; a config's own name is an id
#: too (only zamba2's differs from its module's)
ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES["zamba2-1.2b"] = "zamba2_1p2b"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get(name: str):
    name = ALIASES.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def get_smoke(name: str):
    name = ALIASES.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{name}").SMOKE


def long_context_ok(name: str) -> bool:
    return get(name).supports_long_context()


def cells():
    """All 40 (arch x shape) cells; yields (arch, shape, runnable, why)."""
    for a in ARCHS:
        for s in SHAPES.values():
            if s.name == "long_500k" and not long_context_ok(a):
                yield a, s, False, "full-attention arch: no sub-quadratic path (DESIGN.md)"
            else:
                yield a, s, True, ""
