"""The port's seeded program generator (``repro_torch.programs.
generator``) against the JAX reference's: the packed images of 200 seeds
across the four CONFIGS, hostile constructs included, equal the
reference's bit for bit; and a sample of generated programs through the
port's compiled tiers gives every leaf of the reference's
``run_program`` (tolerance: none).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro.core import EGPUConfig as RCfg  # noqa: E402
from repro.core import run_program as ref_run  # noqa: E402
from repro.core.executor import pad_image as ref_pad  # noqa: E402
from repro.programs.generator import generate_program as ref_gen  # noqa: E402
from repro_torch.core import EGPUConfig, run_compiled  # noqa: E402
from repro_torch.core.executor import pad_image  # noqa: E402
from repro_torch.core.machine import state_to_numpy  # noqa: E402
from repro_torch.programs.generator import generate_program  # noqa: E402

SEEDS = range(200)


@pytest.mark.parametrize("name", sorted(tp.CONFIGS))
def test_packed_images_equal_the_reference(name):
    rcfg, pcfg = tp.config(RCfg, name), tp.config(EGPUConfig, name)
    for seed in SEEDS:
        for hostility in (0.0, 1.0):
            ri = ref_gen(rcfg, seed, hostility=hostility)
            pi = generate_program(pcfg, seed, hostility=hostility)
            assert pi.threads_active == ri.threads_active, seed
            assert np.array_equal(pi.words, ri.words), (seed, hostility)
            assert np.array_equal(pad_image(pi)[0], ref_pad(ri)[0]), seed


#: (config, seed, hostility) of the run sample: 20 programs
SAMPLE = [(name, seed, h) for name in sorted(tp.CONFIGS)
          for seed, h in ((3, 0.0), (17, 0.0), (42, 0.0), (1002, 1.0),
                          (77, 1.0))]


@pytest.mark.parametrize("name,seed,hostility", SAMPLE,
                         ids=[f"{n}-{s}-{h}" for n, s, h in SAMPLE])
def test_generated_programs_through_the_tiers(name, seed, hostility):
    """Every leaf of ``run_compiled`` (blocks, superblock, auto; a
    program the compiler rejects takes the interpreter) equals the
    reference's ``run_program``."""
    rcfg, pcfg = tp.config(RCfg, name), tp.config(EGPUConfig, name)
    ri = ref_gen(rcfg, seed, hostility=hostility)
    pi = generate_program(pcfg, seed, hostility=hostility)
    shared = np.random.default_rng(seed).integers(
        0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    ref = tp.reference_leaves(ref_run(ri, shared_init=shared, tdx_dim=16))
    for mode in ("blocks", "superblock", "auto"):
        got = run_compiled(pi, shared_init=shared, tdx_dim=16, mode=mode,
                           device="cpu")
        tp.assert_leaves_equal(ref, state_to_numpy(got),
                               f"{name}/{seed}/{mode}")
