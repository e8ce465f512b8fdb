"""Generated programs through the port's interpreter and heterogeneous
fleet against the JAX reference, on the CPU: every ``MachineState`` leaf
(tolerance: none) of the port's ``run_program`` (one core at a time)
and of one ``fleet_run`` batch mixing six generated programs, each with
its own TDX grid and shared image, equals the reference's lock-step
fleet of the same cores — clean and hostile programs (stack faults,
bad branches, out-of-range accesses included) in all four CONFIGS.
The reference's ``fleet_run`` equals its ``run_program`` core for core
by its own contract (``tests/test_fleet.py``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro.core import EGPUConfig as RCfg  # noqa: E402
from repro.fleet import fleet_run as ref_fleet_run  # noqa: E402
from repro.fleet import unstack_state as ref_unstack  # noqa: E402
from repro.programs.generator import generate_program as ref_gen  # noqa: E402
from repro_torch.core import EGPUConfig, run_program  # noqa: E402
from repro_torch.core.machine import state_to_numpy  # noqa: E402
from repro_torch.fleet import fleet_run, unstack_state  # noqa: E402
from repro_torch.programs.generator import generate_program  # noqa: E402

SEEDS = range(200, 206)
TDX = (4, 8, 16, 32, 8, 16)
CASES = [(name, h) for name in sorted(tp.CONFIGS) for h in (0.0, 1.0)]


@pytest.mark.parametrize("name,hostility", CASES,
                         ids=[f"{n}-{h}" for n, h in CASES])
def test_generated_programs_through_the_interpreter_and_fleet(name,
                                                              hostility):
    rcfg, pcfg = tp.config(RCfg, name), tp.config(EGPUConfig, name)
    rimgs = [ref_gen(rcfg, s, hostility=hostility) for s in SEEDS]
    pimgs = [generate_program(pcfg, s, hostility=hostility) for s in SEEDS]
    kw = [dict(tdx_dim=t, shared_init=np.random.default_rng(s).integers(
              0, 2**32, 64, dtype=np.uint64).astype(np.uint32))
          for s, t in zip(SEEDS, TDX)]
    ref = ref_fleet_run(rimgs, init_kw=kw)
    got = fleet_run(pimgs, init_kw=kw, device="cpu")
    for k, (seed, img) in enumerate(zip(SEEDS, pimgs)):
        exp = tp.reference_leaves(ref_unstack(ref, k))
        label = f"{name}/{seed}/{hostility}"
        tp.assert_leaves_equal(exp, state_to_numpy(unstack_state(got, k)),
                               f"fleet {label}")
        tp.assert_leaves_equal(
            exp, state_to_numpy(run_program(img, device="cpu", **kw[k])),
            f"run_program {label}")
