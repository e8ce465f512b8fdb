"""The paper-size benchmark suite and its leaf digests.

The jobs are the paper's Table 7 and Table 8 programs at the paper's
sizes (``benchmarks/paper_tables.py`` in the reference): reduction,
transpose and matmul at n = 32, 64, 128, the DOT/SUM variants at the
Table 7 "Dot" sizes, bitonic sort and FFT at n = 32 .. 256, each on the
paper's benchmark configuration (``benchmark_config("dp")``: 512
threads, 32 registers, 128 KB shared memory) with the extension unit or
two predicate levels where the program needs them.

The suite is plain data so that the JAX reference and the port build
the same jobs; :func:`leaf_digests` fingerprints a final state's leaves
in the reference's dtypes, so a run on the card, where there is no JAX,
can be tied to the reference through a committed file of digests
(one for the programs as built, one for them through the verified
optimizer).
"""
from __future__ import annotations

import hashlib
import json
import pathlib

import numpy as np

#: configuration name -> ``benchmark_config`` keyword arguments
CONFIGS = {
    "dp": {},
    "dot": {"has_dot": True},
    "pred2": {"predicate_levels": 2},
}

#: (program, n, builder keyword arguments, configuration name)
SUITE = tuple(
    [(p, n, {}, "dp") for n in (32, 64, 128)
     for p in ("reduction", "transpose", "matmul")]
    + [("reduction", n, {"use_dot": True}, "dot") for n in (32, 64, 128)]
    + [("matmul", n, {"use_dot": True}, "dot") for n in (32, 64)]
    + [("bitonic", n, {}, "pred2") for n in (32, 64, 128, 256)]
    + [("fft", n, {}, "dp") for n in (32, 64, 128, 256)])

DIGESTS_PATH = pathlib.Path(__file__).resolve().parent \
    / "reference_digests.json"
#: the same jobs through ``compile_program(optimize=True).run``: the
#: verified optimizer's images (the FFT jobs change; the rest round-trip)
OPTIMIZED_DIGESTS_PATH = DIGESTS_PATH.with_name(
    "reference_digests_optimized.json")


def build_suite(programs_mod, benchmark_config, suite=SUITE,
                config=None) -> list:
    """Build every job of ``suite`` with a package's builders
    (``programs_mod.build_<program>``) and ``benchmark_config``.
    ``config`` forces one configuration name for every job (a fleet
    batch must share one configuration)."""
    out = []
    for prog, n, kw, cname in suite:
        cfg = benchmark_config(**CONFIGS[config or cname])
        out.append(getattr(programs_mod, f"build_{prog}")(cfg, n, **kw))
    return out


def leaf_digests(leaves: dict) -> dict:
    """BLAKE2b of every leaf: dtype, shape and bytes in the reference's
    dtype (``state_to_numpy`` gives the port's leaves that way)."""
    out = {}
    for name, v in leaves.items():
        arr = np.array(v, order="C")
        h = hashlib.blake2b(digest_size=16)
        h.update(f"{arr.dtype.str}{arr.shape}".encode())
        h.update(arr.tobytes())
        out[name] = h.hexdigest()
    return out


def load_digests(path=DIGESTS_PATH) -> dict:
    with open(path) as f:
        return json.load(f)["jobs"]
