"""The committed optimized-run digests equal the JAX reference's.

``src/repro_torch/programs/reference_digests_optimized.json`` holds a
BLAKE2 digest of every ``MachineState`` leaf of the JAX reference's
``compile_program(image, optimize=True).run(...)`` for each paper-size
suite job (``repro_torch.programs.suite.SUITE``), in the format of
``reference_digests.json``.  ``chip_smoke.py`` holds the port's
optimized compiled runs against it on the card, where there is no JAX;
this test ties the file to the reference.  Tolerance: none, digests are
of exact bytes.

Regenerate the file with ``PYTHONPATH=src python
tests/test_torch_golden_optimized.py --write``.
"""
import json
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

from repro import programs as ref_programs  # noqa: E402
from repro.core import benchmark_config as ref_config  # noqa: E402
from repro.core import compile_program as ref_compile  # noqa: E402
from repro_torch.programs import suite  # noqa: E402


def _reference_job(i):
    b = suite.build_suite(ref_programs, ref_config, suite.SUITE[i:i + 1])[0]
    st = ref_compile(b.image, optimize=True).run(shared_init=b.shared_init,
                                                 tdx_dim=b.tdx_dim)
    leaves = {f: np.asarray(getattr(st, f)) for f in st._fields}
    return b.name, {"config": suite.SUITE[i][3],
                    "steps": int(leaves["steps"]),
                    "cycles": int(leaves["cycles"]),
                    "leaves": suite.leaf_digests(leaves)}


@pytest.mark.parametrize("i", range(len(suite.SUITE)))
def test_reference_optimized_digests_match_committed(i):
    name, got = _reference_job(i)
    committed = suite.load_digests(suite.OPTIMIZED_DIGESTS_PATH)
    assert name in committed, f"{name} missing from the digest file"
    assert committed[name] == got, f"{name}: regenerate with --write"


def test_optimized_digest_file_covers_exactly_the_suite():
    names = [b.name for b in suite.build_suite(ref_programs, ref_config)]
    assert sorted(names) == sorted(
        suite.load_digests(suite.OPTIMIZED_DIGESTS_PATH))


def _write():
    jobs = dict(_reference_job(i) for i in range(len(suite.SUITE)))
    with open(suite.OPTIMIZED_DIGESTS_PATH, "w") as f:
        json.dump({"format": "blake2b-16 of dtype.str + shape + bytes, "
                             "reference dtypes",
                   "run": "compile_program(image, optimize=True).run",
                   "jobs": jobs}, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(jobs)} jobs to {suite.OPTIMIZED_DIGESTS_PATH}")


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: PYTHONPATH=src python "
                 "tests/test_torch_golden_optimized.py --write")
    _write()
