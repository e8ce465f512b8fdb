"""The port's multi-device fleet (``repro_torch.fleet.sharded``,
``repro_torch.fleet.devices`` and the per-device service) against the
JAX package's single-device scheduler, on the CPU: the port of
``test_multidevice.py``.

The reference's contract: sharding the job stream across devices is a
*placement* decision, never a *results* decision.  So the port's
``ShardedFleetScheduler`` over one CPU lane and over four
(``torch.device("cpu", i)``, i = 0..3: the port's counterpart of XLA's
``--xla_force_host_platform_device_count=4``) must give, for the same
submissions, ``JobResult``s bit-identical to the reference's plain
``FleetScheduler`` (shared words as uint32, cycles, steps, time, hazard
violations, the Fig. 6 counters, the tier, the event counters;
tolerance: none), on each tier, on the megabatch path and on repeat
drains that hit residency.  A dead device costs capacity, never
availability and never a job: under ``device_fail`` chaos every future
of the per-device service resolves, and the last healthy device is
never killed.  Until a host with several cards exists, these four CPU
lanes are where N-device runs are held.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro import fleet as rfleet  # noqa: E402
from repro import programs as rprog  # noqa: E402
from repro.core import EGPUConfig as RCfg  # noqa: E402
from repro.core.blockc import TierPolicy as RPolicy  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402
from repro_torch.core import EGPUConfig, compile_program, run_program  # noqa: E402
from repro_torch.core import machine as pmachine  # noqa: E402
from repro_torch.core.blockc import TierPolicy  # noqa: E402
from repro_torch.fleet import (FaultPlan, Fleet, FleetService,  # noqa: E402
                               ShardedFleetScheduler, balance_units,
                               device_label, fleet_devices, make_job_mesh)

RCFG, PCFG = tp.config(RCfg, "dp"), tp.config(EGPUConfig, "dp")
LANES = {1: [torch.device("cpu", 0)],
         4: [torch.device("cpu", i) for i in range(4)]}
WAIT = 300

_FORCE = dict(batch_superblock_min=10**9, min_backedge_dispatches=10**9,
              min_trace_fusion=10**9, min_fori_execd=10**9)
#: tier -> (reference scheduler keywords, port scheduler keywords); the
#: port's interpreter tier is held against the reference's compiled run
#: of the same submissions, whose leaves are its interpreter's by the
#: reference's own contract (and whose XLA compiles take seconds, not a
#: minute)
TIERS = {
    "interp": ({}, {"use_compiler": False}),
    "blocks": ({"tier_policy": RPolicy(**_FORCE)},
               {"tier_policy": TierPolicy(**_FORCE)}),
    "superblock": ({}, {}),
}

#: (builder, n, keyword arguments): test_multidevice.py's suite at the
#: 32-thread configuration of tests/_torch_port.py
SUITE = (("reduction", 32, {}), ("reduction", 32, {"use_dot": True}),
         ("reduction", 16, {}), ("transpose", 16, {}), ("matmul", 8, {}),
         ("bitonic", 16, {}), ("fft", 16, {}))


def _build(mod, cfg, i):
    prog, n, kw = SUITE[i]
    return getattr(mod, f"build_{prog}")(cfg, n, **kw)


def _jobs(idx):
    """``[(reference bench, port bench)]`` for suite indices ``idx``."""
    return [(_build(rprog, RCFG, i), _build(tprog, PCFG, i)) for i in idx]


def _run(sched, benches):
    hs = [sched.submit(b.image, b.shared_init, tdx_dim=b.tdx_dim,
                       tag=b.name) for b in benches]
    rs = sched.drain()
    return [rs[h] for h in hs]


def _reference(jobs, **kw):
    return _run(rfleet.FleetScheduler(RCFG, batch_size=4, **kw),
                [r for r, _ in jobs])


#: the per-tier tests' submissions, the same for one lane and four: each
#: suite program 3 times (same-program groups for the compiled tiers,
#: spread over the lanes by cost; smaller than one lane's slab, so no
#: group is split between the megabatch and a lane)
MIX = [i % len(SUITE) for i in range(3 * len(SUITE))]
_REFERENCE: dict = {}


def _mix_reference(tier):
    """The reference's results for :data:`MIX` as ``TIERS[tier]`` runs
    them, drained once a test process (both lane counts share them)."""
    kw = TIERS[tier][0]
    key = tuple(sorted(kw))
    if key not in _REFERENCE:
        _REFERENCE[key] = _reference(_jobs(MIX), **kw)
    return _REFERENCE[key]


def assert_same(ref, got, label, tier=True):
    fields = ("tag", "cycles", "steps", "time_us", "hazard_violations")
    for f in fields + (("tier",) if tier else ()):
        assert getattr(got, f) == getattr(ref, f), f"{label}: {f}"
    for f in ("shared", "stat_cycles", "stat_instrs"):
        r, g = getattr(ref, f), np.asarray(getattr(got, f))
        assert r.dtype == g.dtype and r.shape == g.shape, f"{label}: {f}"
        assert np.array_equal(r, g), f"{label}: {f}"
    if tier:
        assert (got.counters is None) == (ref.counters is None), label
        if ref.counters is not None:
            assert got.counters.flat() == ref.counters.flat(), label


def _all_same(refs, gots, label, tier=True):
    assert len(refs) == len(gots), label
    for k, (r, g) in enumerate(zip(refs, gots)):
        assert_same(r, g, f"{label}/{k}", tier)


# ---------------------------------------------------------------------------
# the sharded scheduler: one lane and four, every tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes", sorted(LANES))
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_sharded_bit_identical_per_tier(tier, lanes):
    """ShardedFleetScheduler over 1 or 4 CPU lanes == the reference's
    single-device FleetScheduler, for the suite, on every tier; with
    four lanes the work spreads over more than one."""
    jobs = _jobs(MIX)
    sh = ShardedFleetScheduler(PCFG, batch_size=4, devices=LANES[lanes],
                               **TIERS[tier][1])
    got = _run(sh, [p for _, p in jobs])
    _all_same(_mix_reference(tier), got, f"{tier}/{lanes}",
              tier=tier != "interp")
    tiers = {r.tier for r in got}
    assert (tiers == {"interp"}) if tier == "interp" else (tier in tiers)
    per = sh.stats.per_device()
    assert sum(d["jobs"] for d in per.values()) == len(jobs)
    if lanes > 1:
        assert len([k for k in per if k != "mesh"]) >= 2, per


@pytest.mark.parametrize("lanes", sorted(LANES))
def test_sharded_matches_sequential_runs(lanes):
    """...and matches N independent ``run_program`` calls (the port's,
    which ``test_torch_executor.py`` holds to the reference's)."""
    jobs = _jobs(MIX)
    got = _run(ShardedFleetScheduler(PCFG, batch_size=4,
                                     devices=LANES[lanes]),
               [p for _, p in jobs])
    for (_, pb), g in zip(jobs, got):
        st = run_program(pb.image, shared_init=pb.shared_init,
                         tdx_dim=pb.tdx_dim, device="cpu")
        assert np.array_equal(pmachine.shared_as_u32(st), g.shared_u32())
        assert int(st.cycles) == g.cycles, pb.name


@pytest.mark.parametrize("lanes", sorted(LANES))
def test_megabatch_path(lanes):
    """Same-program runs >= one slab (lanes * batch) ride the megabatch
    path, one shard a lane: results equal the reference's, and the
    slabs report under ``device="mesh"``."""
    sh = ShardedFleetScheduler(PCFG, batch_size=4, devices=LANES[lanes])
    n_slabs = 3 if lanes == 1 else 2
    n = sh._slab * n_slabs + 2
    jobs = _jobs([0] * n)
    got = _run(sh, [p for _, p in jobs])
    # the remainder's group is smaller than the reference's whole group,
    # so the tier policy may see another batch hint for it
    _all_same(_reference(jobs), got, f"mega/{lanes}", tier=False)
    per = sh.stats.per_device()
    assert per["mesh"]["jobs"] == sh._slab * n_slabs
    assert per["mesh"]["batches"] == n_slabs
    assert sum(d["jobs"] for d in per.values()) == n
    # each lane's shard ran through the plan on that lane's device
    cp = compile_program(jobs[0][1].image, policy=sh.tier_policy,
                         batch_hint=4)
    keys = {d for d, b in cp._plans if b == 4}
    assert set(LANES[lanes]) <= keys


def test_sharded_repeat_drains_hit_residency():
    """Per-device megabatch inputs survive across drains; the repeat
    drain replays them and still equals the reference."""
    sh = ShardedFleetScheduler(PCFG, batch_size=4, devices=LANES[4])
    jobs = _jobs([4] * sh._slab)
    first = _run(sh, [p for _, p in jobs])
    second = _run(sh, [p for _, p in jobs])
    assert sh._mega_residency.hits > 0
    ref = _reference(jobs)
    _all_same(ref, first, "first")
    _all_same(ref, second, "second")
    assert sh.stats.residency_hits == 1


def test_fleet_facade_devices_knob():
    jobs = _jobs(MIX)
    for devices in (LANES[1], LANES[4]):
        fl = Fleet(PCFG, batch_size=4, devices=devices)
        assert isinstance(fl._sched, ShardedFleetScheduler)
        assert fl._sched.devices == tuple(devices)
        hs = [fl.submit(p.image, p.shared_init, tdx_dim=p.tdx_dim,
                        tag=p.name) for _, p in jobs]
        res = fl.drain()
        _all_same(_mix_reference("superblock"), [res[h] for h in hs],
                  str(len(devices)))


# ---------------------------------------------------------------------------
# topology helpers (host logic)
# ---------------------------------------------------------------------------

def test_device_resolution_and_labels():
    devs = fleet_devices(LANES[4])
    assert devs == tuple(LANES[4])
    assert [device_label(d) for d in devs] == [f"cpu:{i}" for i in range(4)]
    assert fleet_devices("cpu") == (torch.device("cpu"),)
    assert fleet_devices(torch.device("cpu", 2)) == (torch.device("cpu", 2),)
    assert device_label(None) == "default"
    mesh = make_job_mesh(devs)
    assert mesh.devices == devs and mesh.axis_names == ("jobs",)
    with pytest.raises(ValueError):
        fleet_devices(0)
    with pytest.raises(ValueError):
        fleet_devices([])
    if not torch.cuda.is_available():    # the CPU only when named
        for spec in ("all", None, 1, "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fleet_devices(spec)
    else:
        n = torch.cuda.device_count()
        assert fleet_devices("all") == tuple(torch.device("cuda", i)
                                             for i in range(n))
        with pytest.raises(ValueError, match="devices="):
            fleet_devices(n + 1)


def test_balance_units_lpt_as_the_reference():
    units = [("a", 10.0), ("b", 8.0), ("c", 2.0), ("d", 2.0),
             ("e", 1.0), ("f", 1.0)]
    for n in (1, 2, 4):
        assert balance_units(units, n, cost=lambda u: u[1]) == \
            rfleet.balance_units(units, n, cost=lambda u: u[1])
    lanes = balance_units(units, 2, cost=lambda u: u[1])
    assert sorted(sum(u[1] for u in lane) for lane in lanes) == [12.0, 12.0]
    lanes = balance_units(units[:2], 4, cost=lambda u: u[1])
    assert sorted(len(x) for x in lanes) == [0, 0, 1, 1]


# ---------------------------------------------------------------------------
# the per-device service: failover
# ---------------------------------------------------------------------------

#: the service's scheduler defaults (one plan shape a program, and a
#: singleton rides the compiled tier)
SERVE = dict(compile_min=1, fixed_bucket=True)


def _serve(jobs, n, **kw):
    svc = FleetService(PCFG, batch_size=4, max_delay_s=0.001, **kw)
    try:
        futs = [svc.submit(p.image, p.shared_init, tdx_dim=p.tdx_dim,
                           tag=p.name) for _, p in jobs]
        res = [f.result(timeout=WAIT) for f in futs]
    finally:
        svc.close()
    assert len(res) == n
    return res, svc


def test_device_kill_chaos_every_future_resolves():
    """Kill one whole device mid-load: every future resolves, failed ==
    0 (a device death consumes no retry attempt), results equal the
    reference's, and only the dead device leaves the healthy set."""
    victim = device_label(LANES[4][1])
    plan = FaultPlan(seed=5, device_fail={"p": 1.0, "count": 1,
                                          "where": {"device": victim}})
    jobs = _jobs([0] * 40)
    res, svc = _serve(jobs, 40, devices=LANES[4], faults=plan)
    assert plan.injected["device_fail"] == 1
    assert svc.stats.failed == 0
    _all_same(_reference(jobs[:1], **SERVE) * 40, res, "chaos")
    healthy = svc.healthy_devices
    assert victim not in healthy and len(healthy) == 3
    assert svc.metrics.total("serve_device_unhealthy", device=victim) == 1


def test_last_healthy_device_never_killed():
    """A device_fail plan that matches every device can only retire
    N-1 of them: the last healthy dispatcher refuses to die and keeps
    serving."""
    jobs = _jobs([0] * 24)
    res, svc = _serve(jobs, 24, devices=LANES[4],
                      faults=FaultPlan(seed=9, device_fail=1.0))
    assert svc.stats.failed == 0
    assert len(svc.healthy_devices) == 1
    _all_same(_reference(jobs[:1], **SERVE) * 24, res, "last")


def test_service_multi_device_bit_identical_and_spread():
    """Per-device dispatchers draining the shared queue: results equal
    the reference's single-dispatcher service and more than one device
    does work."""
    jobs = _jobs([i % len(SUITE) for i in range(32)])
    many, svc = _serve(jobs, 32, devices=LANES[4])
    rsvc = rfleet.FleetService(RCFG, batch_size=4, max_delay_s=0.001)
    try:
        futs = [rsvc.submit(r.image, r.shared_init, tdx_dim=r.tdx_dim,
                            tag=r.name) for r, _ in jobs]
        one = [f.result(timeout=WAIT) for f in futs]
    finally:
        rsvc.close()
    _all_same(one, many, "service")
    snap = svc.metrics.snapshot()
    used = {s["labels"]["device"]
            for s in snap._metric("serve_dispatches_total")["samples"]
            if s["value"]}
    assert len(used) >= 2, f"dispatches must spread: {used}"
