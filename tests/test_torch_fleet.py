"""The port's lock-step fleet against the JAX reference, leaf for leaf.

A heterogeneous ``fleet_run`` batch — different programs, thread counts,
TDX grids and shared images on one configuration — must give every core
exactly the leaves the reference's ``run_program`` gives that job alone
(tolerance: none).  Also: an already-batched input state, and the batch
helpers.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro import programs as rprog  # noqa: E402
from repro.core import EGPUConfig as RCfg  # noqa: E402
from repro.core import run_program as ref_run  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402
from repro_torch.core import EGPUConfig  # noqa: E402
from repro_torch.core.machine import init_state, state_to_numpy  # noqa: E402
from repro_torch.fleet import fleet_run, stack_states, unstack_state  # noqa: E402


@pytest.mark.parametrize("name", sorted(tp.CONFIGS))
def test_heterogeneous_batch_matches_reference(name):
    rb = tp.suite(rprog, tp.config(RCfg, name))
    pb = tp.suite(tprog, tp.config(EGPUConfig, name))
    order = sorted(pb)[::-1]            # longest-running jobs first
    out = fleet_run([pb[i].image for i in order],
                    init_kw=[dict(shared_init=pb[i].shared_init,
                                  tdx_dim=pb[i].tdx_dim) for i in order],
                    device="cpu")
    for k, i in enumerate(order):
        ref = ref_run(rb[i].image, shared_init=rb[i].shared_init,
                      tdx_dim=rb[i].tdx_dim)
        tp.assert_leaves_equal(tp.reference_leaves(ref),
                               state_to_numpy(unstack_state(out, k)),
                               f"{name}/{pb[i].name}")


def test_batched_state_input_and_mixed_thread_counts():
    """The same program on three cores with 16, 32 and 32 threads and
    different shared images, given as one batched state."""
    rcfg, pcfg = tp.config(RCfg, "dp"), tp.config(EGPUConfig, "dp")
    rng = np.random.default_rng(9)
    rjob, pjob = rprog.build_reduction(rcfg, 32), tprog.build_reduction(pcfg, 32)
    datas = [rng.standard_normal(32).astype(np.float32) for _ in range(3)]
    threads = [16, 32, 32]
    st = stack_states([init_state(pcfg, threads=t, tdx_dim=32, shared_init=d,
                                  device="cpu")
                       for t, d in zip(threads, datas)])
    out = fleet_run([pjob.image] * 3, st)
    for k, (t, d) in enumerate(zip(threads, datas)):
        ref = ref_run(rjob.image, threads=t, tdx_dim=32, shared_init=d)
        tp.assert_leaves_equal(tp.reference_leaves(ref),
                               state_to_numpy(unstack_state(out, k)),
                               f"core {k}")


def test_fleet_rejects_mixed_configs_and_missing_card():
    a = tprog.build_reduction(tp.config(EGPUConfig, "dp"), 32)
    b = tprog.build_reduction(tp.config(EGPUConfig, "qp"), 32)
    with pytest.raises(ValueError):
        fleet_run([a.image, b.image], device="cpu")
    with pytest.raises(ValueError):
        fleet_run([], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet_run([a.image])
