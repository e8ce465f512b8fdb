"""The check catches a broken timed path: small cells run on the CPU
through the whole harness (all but its look for a card) with a fault
planted under it, and ``correct`` comes out false.  The faults are those
an eGPU cell can have: a run that leaves its state unchanged, half of a
batch's results left out, an answer altered where it is produced (the
wavefront ALU's add), and one altered in a single lane of a batch (its
last).  With no fault the same cells are correct."""
import pytest
import torch

from portbench import harness

SWEEP = {"lanes": 4, "batch_size": 4, "lanes_per_drain": 2,
         "drains_per_program": 1,
         "programs": ["reduction_32_dp", "transpose_32_dp", "fft_32_dp",
                      "matmul_32_dp"]}
SERVICE = {"batch_size": 4, "rate_per_s": 8.0, "sample_per_program": 2,
           "whole_max_steps": 100,
           "warmup_rounds": 1, "profile_s": 0.0,
           "programs": ["reduction_32_dp", "fft_32_dp", "matmul_32_dp"]}
SEED = 2 ** 31 + 4242


def sweep():
    return harness.run_cell("egpu-dp.sweep", SEED, 0.3, False,
                            device="cpu", traffic=SWEEP)


def service():
    return harness.run_cell("egpu-dp.service", SEED, 1.0, False,
                            device="cpu", traffic=SERVICE)


def stuck(monkeypatch):
    """A run that returns its state unchanged: no unit runs."""
    from repro_torch.core import blockc
    run = blockc._Plan._run

    def _run(self, shared, tdx):
        order, self.order = self.order, []
        try:
            run(self, shared, tdx)
        finally:
            self.order = order
    monkeypatch.setattr(blockc._Plan, "_run", _run)


def half_left_out(monkeypatch):
    """Half of each compiled batch's results never collected."""
    from repro_torch.fleet import scheduler
    collect = scheduler.FleetScheduler._collect_light

    def _collect(self, cp, shared_dev, batch, real, wall, results):
        collect(self, cp, shared_dev, batch, max(1, real // 2), wall,
                results)
    monkeypatch.setattr(scheduler.FleetScheduler, "_collect_light",
                        _collect)


def add_altered(monkeypatch):
    """The wavefront ALU's add flips the low bit of every result."""
    from repro_torch.kernels import fp32
    add = fp32.BINARY["add"]
    monkeypatch.setitem(fp32.BINARY, "add",
                        lambda a, b: add(a, b) ^ torch.ones_like(a))


def last_lane_altered(monkeypatch):
    """The last real lane of every compiled batch comes back with one
    word of its shared memory flipped: a fault of one lane in a batch."""
    from repro_torch.fleet import scheduler
    collect = scheduler.FleetScheduler._collect_light

    def _collect(self, cp, shared_dev, batch, real, wall, results):
        collect(self, cp, shared_dev, batch, real, wall, results)
        results[batch[real - 1].handle].shared[0] ^= 1
    monkeypatch.setattr(scheduler.FleetScheduler, "_collect_light",
                        _collect)


def test_sound_cells_are_correct():
    for out in (sweep(), service()):
        assert out["correct"], out["checks"]
        assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("fault", [stuck, half_left_out, add_altered,
                                   last_lane_altered])
def test_a_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = sweep()
    assert not out["correct"], out["checks"]


def test_an_altered_service_answer_is_not_correct(monkeypatch):
    add_altered(monkeypatch)
    out = service()
    assert not out["correct"] and out["checks"]["jobs_wrong"]["value"] > 0
