"""The copy down of a compiled batch's final shared images
(``scheduler._download``, ``FleetScheduler._collect_light``) on the CPU.

From a card the images land in page-locked host memory, counted in
``fleet_download_bytes_total`` (``tests/test_torch_cuda.py`` holds that
on the card).  On the CPU the outputs are the image and nothing is
copied down: a traced drain's ``download`` spans carry ``pinned_bytes``
0 and the counter stays 0.  The results stay bit-identical to the
reference's ``FleetScheduler`` for the port's scheduler and for its
sharded fleet over four CPU lanes (a megabatch's shards joined in row
order), and a result still held is not changed by later drains.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro import fleet as rfleet  # noqa: E402
from repro import programs as rprog  # noqa: E402
from repro.core import EGPUConfig as RCfg  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402
from repro_torch.core import EGPUConfig  # noqa: E402
from repro_torch.fleet import FleetScheduler, ShardedFleetScheduler  # noqa: E402
from repro_torch.fleet import scheduler as sched_mod  # noqa: E402

RCFG, PCFG = tp.config(RCfg, "dp"), tp.config(EGPUConfig, "dp")
LANES = [torch.device("cpu", i) for i in range(4)]
#: (builder, n): two programs, the first in numbers enough to fill the
#: four lanes' megabatch slab (4 lanes x 4 jobs) with a remainder
PROGS = (("reduction", 32), ("matmul", 8))
COUNTS = (19, 3)


def _sched(kind, **kw):
    if kind == "sharded":
        return ShardedFleetScheduler(PCFG, batch_size=4, devices=LANES,
                                     **kw)
    return FleetScheduler(PCFG, batch_size=4, device="cpu", **kw)


def _jobs(seed):
    """``[(program index, float32 data)]``: each program's jobs with
    fresh data of its own input's size."""
    rng = np.random.default_rng(seed)
    out = []
    for k, ((prog, n), count) in enumerate(zip(PROGS, COUNTS)):
        size = np.asarray(getattr(tprog, f"build_{prog}")(PCFG, n)
                          .shared_init).size
        out += [(k, rng.standard_normal(size).astype(np.float32))
                for _ in range(count)]
    return out


def _drain(sched, mod, cfg, jobs):
    """Submit ``jobs`` of ``mod``'s programs; results in submit order."""
    benches = [getattr(mod, f"build_{p}")(cfg, n) for p, n in PROGS]
    hs = [sched.submit(benches[k].image, data, tdx_dim=benches[k].tdx_dim)
          for k, data in jobs]
    rs = sched.drain()
    return [rs[h] for h in hs]


@pytest.mark.parametrize("kind", ["fleet", "sharded"])
def test_cpu_download_is_not_pinned_and_counts_nothing(kind):
    """Every ``download`` span of a traced CPU drain (the sharded
    fleet's megabatch and lanes alike) carries ``pinned_bytes`` 0 beside
    its ``bytes``, and ``fleet_download_bytes_total`` stays 0."""
    sh = _sched(kind, trace=True)
    got = _drain(sh, tprog, PCFG, _jobs(1))
    assert len(got) == sum(COUNTS)
    downs = [e["args"] for e in sh.tracer.events
             if e.get("name") == "download" and e.get("ph") == "X"]
    assert downs
    for a in downs:
        assert a["pinned_bytes"] == 0
        assert a["bytes"] > 0 and a["bytes"] % (PCFG.shared_words * 4) == 0
    if kind == "sharded":
        assert max(a["bytes"] for a in downs) == 16 * PCFG.shared_words * 4
    reg = sh.stats.registry
    assert reg.total("fleet_download_bytes_total") == 0
    assert reg.value("fleet_download_bytes_total", host="pinned") == 0
    assert reg.value("fleet_download_bytes_total", host="pageable") == 0


@pytest.mark.parametrize("kind", ["fleet", "sharded"])
def test_results_equal_the_reference(kind):
    """The same submissions to the reference's ``FleetScheduler`` and to
    the port's (the sharded fleet's megabatch over four lanes included):
    shared words as uint32, cycles, steps, time, hazards and the Fig. 6
    counters equal; tolerance none."""
    jobs = _jobs(2)
    ref = _drain(rfleet.FleetScheduler(RCFG, batch_size=4), rprog, RCFG,
                 jobs)
    sh = _sched(kind)
    got = _drain(sh, tprog, PCFG, jobs)
    if kind == "sharded":
        assert sh.stats.per_device()["mesh"]["jobs"] == 16
    for k, (r, g) in enumerate(zip(ref, got)):
        for f in ("cycles", "steps", "time_us", "hazard_violations"):
            assert getattr(g, f) == getattr(r, f), (k, f)
        for f in ("shared", "stat_cycles", "stat_instrs"):
            rv, gv = getattr(r, f), np.asarray(getattr(g, f))
            assert rv.dtype == gv.dtype and rv.shape == gv.shape, (k, f)
            assert np.array_equal(rv, gv), (k, f)


@pytest.mark.parametrize("kind", ["fleet", "sharded"])
def test_held_results_survive_later_drains(kind):
    """The results of one drain, still held, read the same after two
    more drains of other data through the same scheduler."""
    sh = _sched(kind)
    held = _drain(sh, tprog, PCFG, _jobs(3))
    words = [r.shared.copy() for r in held]
    for seed in (4, 5):
        later = _drain(sh, tprog, PCFG, _jobs(seed))
        assert any(not np.array_equal(a.shared, b.shared)
                   for a, b in zip(held, later))
    for k, (r, w) in enumerate(zip(held, words)):
        assert np.array_equal(r.shared, w), k


def test_cpu_download_joins_shards_without_a_copy_of_one():
    """On the CPU one output is the image itself; several are joined in
    row order; nothing came down from a card."""
    a = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    b = torch.arange(12, 20, dtype=torch.int32).reshape(2, 4)
    one, host = sched_mod._download([a])
    assert one is a and host is None
    both, host = sched_mod._download([a, b])
    assert host is None
    assert torch.equal(both, torch.arange(20, dtype=torch.int32)
                       .reshape(5, 4))
