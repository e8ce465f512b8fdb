"""One compiled program's plan used from several threads at once.

A :class:`~repro_torch.core.blockc.CompiledProgram` keeps one plan of
static buffers a (device, batch width), and the compile cache shares
it with the whole process.  Four threads run the same program at the
same width through ``run_light_dev`` and ``run_batch``, each with its
own inputs, many times over; every output must equal the JAX
reference's ``run_program`` leaves for that input (tolerance: none).
Without the plan's lock the threads write into each other's buffers
and the outputs mix.  The plan is made by one of the racing threads,
so it is also made once: one plan, captured (on the card) once.
"""
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro import programs as rprog  # noqa: E402
from repro.core import EGPUConfig as RCfg, run_program as ref_run  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402
from repro_torch.core import EGPUConfig, compile_program  # noqa: E402
from repro_torch.core.machine import state_to_numpy  # noqa: E402

THREADS = 4
ROUNDS = 12
BATCH = 2
TDX = (4, 8, 16, 32)


def _inputs(n, size):
    rng = np.random.default_rng(17)
    return [rng.standard_normal(size).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("mode", ["blocks", "superblock"])
def test_one_plan_from_four_threads(mode):
    rb = rprog.build_matmul(tp.config(RCfg, "dp"), 8)
    pb = tprog.build_matmul(tp.config(EGPUConfig, "dp"), 8)
    n = np.asarray(pb.shared_init).size
    datas = _inputs(THREADS * BATCH, n)
    tdx = [TDX[i % len(TDX)] for i in range(THREADS * BATCH)]
    refs = [tp.reference_leaves(ref_run(rb.image, shared_init=d, tdx_dim=t))
            for d, t in zip(datas, tdx)]
    cp = compile_program(pb.image, mode=mode)
    cp._plans.clear()                    # the racing threads make it
    S = cp.cfg.shared_words
    errors, done = [], []
    start = threading.Barrier(THREADS)

    def worker(k):
        rows = list(range(k * BATCH, (k + 1) * BATCH))
        inits = [datas[i] for i in rows]
        tdxs = [tdx[i] for i in rows]
        shared = np.zeros((BATCH, S), np.uint32)
        for j, d in enumerate(inits):
            shared[j, :n] = d.view(np.uint32)
        try:
            start.wait(timeout=60)
            for r in range(ROUNDS):
                if r % 2:
                    got = state_to_numpy(cp.run_batch(inits, tdxs,
                                                      device="cpu"))
                    for j, i in enumerate(rows):
                        tp.assert_leaves_equal(
                            refs[i], {f: v[j] for f, v in got.items()},
                            f"{mode} run_batch thread {k} round {r}")
                else:
                    out = cp.run_light_dev(shared, np.asarray(tdxs),
                                           device="cpu")[0]
                    words = out.numpy().view(np.uint32)
                    for j, i in enumerate(rows):
                        assert np.array_equal(words[j], refs[i]["shared"]), \
                            f"{mode} run_light_dev thread {k} round {r}"
            done.append(k)
        except Exception as e:           # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ths = [threading.Thread(target=worker, args=(k,))
               for k in range(THREADS)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[0]
    assert sorted(done) == list(range(THREADS))
    assert list(cp._plans) == [(torch.device("cpu"), BATCH)]
