"""The port on the card: the hand-written CUDA kernels against their
plain versions, and the CUDA runs against the port's CPU runs.

Every test here needs an NVIDIA GPU with nvcc; without one each skips
(decided in the fixture, never at import).  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX (the card's machine has none): the CPU runs of
the port stand in for the reference, which ``test_torch_executor.py``
ties them to.  Tolerance: none, bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402
from repro_torch.core import EGPUConfig, executor, run_program  # noqa: E402
from repro_torch.core.machine import state_to_numpy  # noqa: E402
from repro_torch.fleet import fleet_run, unstack_state  # noqa: E402
from repro_torch.kernels.dot_product import ops as dops, ref as dref  # noqa: E402
from repro_torch.kernels.wavefront_alu import ops as wops, ref as wref  # noqa: E402

pytestmark = pytest.mark.cuda

SPECIAL = np.array([0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FA00000,
                    0xFFB00000, 0x7F800001, 0x00400000, 0x80400000,
                    0x3F800000, 0x00800000], np.uint32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda)")
    return torch.device("cuda")


def _special(rng, shape):
    bits = rng.integers(0, 2**32, int(np.prod(shape)),
                        dtype=np.uint64).astype(np.uint32)
    pick = rng.random(bits.size) < 0.5
    bits[pick] = SPECIAL[rng.integers(0, len(SPECIAL), pick.sum())]
    return torch.from_numpy(bits.view(np.float32).reshape(shape))


@pytest.mark.parametrize("op", wref.OPS)
@pytest.mark.parametrize("rows,lanes", [(2, 16), (32, 16), (64, 256)])
def test_wavefront_alu_kernel_equals_plain(dev, op, rows, lanes):
    rng = np.random.default_rng(rows * lanes)
    a, b, init = (_special(rng, (rows, lanes)).to(dev) for _ in range(3))
    act = torch.from_numpy(rng.integers(0, 2, -(-rows // 8))
                           .astype(np.int32)).to(dev)
    before = wops.wavefront_alu.launches
    got = wops.wavefront_alu(a, b, init, act, op)
    exp = wref.wavefront_alu_ref(a, b, init, act, op)
    assert wops.wavefront_alu.launches == before + 1
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


@pytest.mark.parametrize("shape", [(8, 128), (3, 32, 16), (32, 512)])
def test_dot_product_kernel_equals_plain(dev, shape):
    rng = np.random.default_rng(len(shape))
    a, b = _special(rng, shape).to(dev), _special(rng, shape).to(dev)
    tiles = shape[:-2] + (-(-shape[-2] // 8),)
    act = torch.from_numpy(rng.integers(0, 2, tiles).astype(np.int32)).to(dev)
    got = dops.dot_product(a, b, act)
    exp = dref.dot_product_ref(a, b, act)
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


def test_run_program_and_fleet_equal_cpu(dev):
    cfg = tp.config(EGPUConfig, "dp")
    jobs = tp.suite(tprog, cfg)
    cpu = {}
    for i, b in jobs.items():
        cpu[i] = state_to_numpy(run_program(
            b.image, shared_init=b.shared_init, tdx_dim=b.tdx_dim,
            device="cpu"))
        got = state_to_numpy(run_program(
            b.image, shared_init=b.shared_init, tdx_dim=b.tdx_dim,
            device=dev))
        tp.assert_leaves_equal(cpu[i], got, b.name)
    order = sorted(jobs)
    out = fleet_run([jobs[i].image for i in order],
                    init_kw=[dict(shared_init=jobs[i].shared_init,
                                  tdx_dim=jobs[i].tdx_dim) for i in order],
                    device=dev)
    for k, i in enumerate(order):
        tp.assert_leaves_equal(cpu[i], state_to_numpy(unstack_state(out, k)),
                               f"fleet {jobs[i].name}")


def test_step_loop_never_syncs(dev, monkeypatch):
    """No host-device synchronisation inside the step loop, single core
    or fleet: every op of the suite (LODI, LOD, STO, FP, DOT/SUM, IF/
    ELSE/ENDIF, ...) runs under CUDA's sync debug mode set to error."""
    inner = executor.run_steps

    def guarded(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(executor, "run_steps", guarded)
    jobs = tp.suite(tprog, tp.config(EGPUConfig, "dp"))
    for b in jobs.values():
        run_program(b.image, shared_init=b.shared_init, tdx_dim=b.tdx_dim,
                    device=dev)
    fleet_run([b.image for b in jobs.values()],
              init_kw=[dict(shared_init=b.shared_init, tdx_dim=b.tdx_dim)
                       for b in jobs.values()], device=dev)
