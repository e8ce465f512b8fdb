"""Shared helpers of the port's differential tests (``test_torch_*``).

The configuration axes and the program suite mirror
``tests/test_blockc.py`` (``CONFIGS``, ``_suite``): 32 threads, 32
registers, 4 KB shared memory, with the 16-bit ALU, no-predicate and
qp-memory variants.  Each helper builds the same thing in both packages
so the tests compare like with like, leaf by leaf.
"""
import numpy as np

CFG_KW = dict(max_threads=32, regs_per_thread=32, shared_kb=4, alu_bits=32,
              shift_bits=32, predicate_levels=4, has_dot=True,
              has_invsqr=True)

#: the satellite configuration axes of test_blockc.py
CONFIGS = {
    "dp": {},
    "qp": {"memory_mode": "qp"},
    "alu16": {"alu_bits": 16, "shift_bits": 16},
    "nopred": {"predicate_levels": 0},
}

#: (builder, n, keyword arguments) — test_blockc.py's _suite
SUITE = (("reduction", 32, {}), ("reduction", 32, {"use_dot": True}),
         ("reduction", 32, {"no_dynamic": True}), ("transpose", 16, {}),
         ("matmul", 8, {}), ("bitonic", 16, {}), ("fft", 16, {}))


def config(config_cls, name):
    return config_cls(**{**CFG_KW, **CONFIGS[name]})


def suite(programs_mod, cfg) -> dict:
    """``{SUITE index: bench}`` for every suite program this
    configuration can assemble."""
    out = {}
    for i, (prog, n, kw) in enumerate(SUITE):
        try:
            out[i] = getattr(programs_mod, f"build_{prog}")(cfg, n, **kw)
        except ValueError:
            pass            # feature not present in this config
    return out


def suite_ids():
    """``(config, index)`` of every job that assembles, for parametrize
    ids (the same filter as :func:`suite`, decided from the feature
    flags, without building anything)."""
    out = []
    for name, kw in CONFIGS.items():
        preds = kw.get("predicate_levels", CFG_KW["predicate_levels"])
        for i, (prog, _n, pkw) in enumerate(SUITE):
            if not preds and (prog == "bitonic" or pkw.get("no_dynamic")):
                continue
            out.append((name, i))
    return out


def reference_leaves(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def assert_leaves_equal(ref: dict, got: dict, label: str):
    assert sorted(ref) == sorted(got), label
    for leaf, r in ref.items():
        g = got[leaf]
        assert r.dtype == g.dtype and r.shape == g.shape, f"{label}: {leaf}"
        assert np.array_equal(r, g), f"{label}: {leaf} differs"
