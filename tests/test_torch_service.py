"""The port's serving loop (``repro_torch.fleet.service``) against the
JAX package's, on the CPU: the port of ``test_service.py``.

The same submissions go to both packages' ``FleetService`` (the port's
with ``device="cpu"``).  Every ``JobResult`` must be bit-identical to
the reference's (shared words as uint32, cycles, steps, time, hazard
violations, the Fig. 6 counters; the tier and the event counters too
where no fault can move a job between tiers; tolerance: none), and so
must the counts that do not depend on the clock: completed, failed,
rejected, lint-rejected, deadline misses of deadlines already passed,
and the watchdog's timeouts.  Cohort boundaries depend on the clock, so
no test compares dispatch counts across the packages.  The fault
plans, the scheduler's tier degradation, bisection and salvage
checksums are held the same way, with the reference's ``run_program``
as the oracle.

Every wait has its own timeout.  The watchdog test measures a warm
drain first and gives the watchdog ten times that (at least 0.3 s),
so a loaded machine cannot trip it on a healthy dispatch.
"""
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro import fleet as rfleet  # noqa: E402
from repro.core import Asm as RAsm, EGPUConfig as RCfg  # noqa: E402
from repro.core import machine as rmachine  # noqa: E402
from repro.core import run_program as ref_run  # noqa: E402
from repro.fleet import faults as rfaults  # noqa: E402
from repro.obs import report as rreport  # noqa: E402
from repro_torch import fleet as pfleet  # noqa: E402
from repro_torch.core import Asm, EGPUConfig  # noqa: E402
from repro_torch.core.blockc import CompiledProgram  # noqa: E402
from repro_torch.fleet import faults as pfaults  # noqa: E402
from repro_torch.obs import report as preport  # noqa: E402

RCFG, PCFG = tp.config(RCfg, "dp"), tp.config(EGPUConfig, "dp")
PKGS = {"ref": (rfleet, RCFG, {}), "port": (pfleet, PCFG, {"device": "cpu"})}
WAIT = 300                               # seconds, any one future


def _loop_prog(a, iters=16):
    """Same-program loop job: lands on the compiled/superblock tiers."""
    a.tdx(1)
    a.lod(2, 1, 0)
    with a.loop(iters):
        a.fadd(2, 2, 2)
    a.sto(2, 1, 0)
    a.stop()
    return a.assemble(threads_active=32)


IMG = {"ref": _loop_prog(RAsm(RCFG)), "port": _loop_prog(Asm(PCFG))}


def _datas(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(32).astype(np.float32) for _ in range(n)]


def _refs(datas, tdx=32):
    return [rmachine.shared_as_u32(
        ref_run(IMG["ref"], shared_init=d, tdx_dim=tdx)) for d in datas]


def _service(pkg, **kw):
    mod, cfg, extra = PKGS[pkg]
    return mod.FleetService(cfg, **kw, **extra)


def _sched(pkg, **kw):
    mod, cfg, extra = PKGS[pkg]
    return mod.FleetScheduler(cfg, **kw, **extra)


def _outcomes(futs):
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=WAIT))
        except Exception as e:           # noqa: BLE001 — JobError compared
            out.append(e)
    return out


def _serve(pkg, datas, *, submit_kw=None, **kw):
    """Every data through one service of ``pkg``; ``(outcomes, svc)``."""
    svc = _service(pkg, **kw)
    try:
        futs = [svc.submit(IMG[pkg], d, **(submit_kw or {})) for d in datas]
        out = _outcomes(futs)
    finally:
        svc.close()
    return out, svc


def assert_same(ref, got, label, tier=True):
    """A port outcome against the reference's: the same JobError kind,
    or a bit-identical JobResult (the tier and event counters only
    where ``tier``: a fault can move a job between tiers, and which one
    it hits depends on the cohort)."""
    if isinstance(ref, Exception):
        assert isinstance(got, Exception), label
        assert (got.kind, got.attempts) == (ref.kind, ref.attempts), label
        return
    assert not isinstance(got, Exception), f"{label}: {got!r}"
    fields = ("tag", "cycles", "steps", "time_us", "hazard_violations")
    for f in fields + (("tier",) if tier else ()):
        assert getattr(got, f) == getattr(ref, f), f"{label}: {f}"
    for f in ("shared", "stat_cycles", "stat_instrs"):
        r, g = getattr(ref, f), np.asarray(getattr(got, f))
        assert r.dtype == g.dtype and r.shape == g.shape, f"{label}: {f}"
        assert np.array_equal(r, g), f"{label}: {f}"
    if tier:
        assert got.counters.flat() == ref.counters.flat(), label


def _same_stats(rs, ps, *fields):
    for f in ("submitted", "completed", "failed", "rejected",
              "lint_rejected") + fields:
        assert getattr(ps.stats, f) == getattr(rs.stats, f), f


# ---------------------------------------------------------------------------
# FleetService basics
# ---------------------------------------------------------------------------

def test_service_round_trip_bit_identical():
    datas = _datas(12)
    kw = dict(batch_size=4, max_delay_s=0.001, submit_kw={"tdx_dim": 32})
    rout, rs = _serve("ref", datas, **kw)
    pout, ps = _serve("port", datas, **kw)
    for k, (r, p, ref) in enumerate(zip(rout, pout, _refs(datas))):
        assert_same(r, p, f"job {k}")
        assert np.array_equal(p.shared_u32(), ref)
    _same_stats(rs, ps, "retries")
    st = ps.stats
    assert st.submitted == st.completed == 12
    assert st.failed == st.retries == st.rejected == 0
    assert st.dispatched_jobs == 12


def test_service_submit_validates_inputs():
    for pkg in PKGS:
        cfg = PKGS[pkg][1]
        with _service(pkg, batch_size=4) as svc:
            with pytest.raises(ValueError):
                svc.submit(IMG[pkg], np.zeros(4, np.complex64))
            with pytest.raises(ValueError):
                svc.submit(IMG[pkg], np.zeros(cfg.shared_words + 1,
                                              np.float32))
            with pytest.raises(ValueError):
                svc.submit(IMG[pkg], threads=cfg.num_sps + 1)
        assert svc.stats.submitted == 0, pkg


def test_deadline_miss_fails_fast():
    outs = {}
    for pkg in PKGS:
        outs[pkg] = _serve(pkg, _datas(1), batch_size=4, max_delay_s=0.5,
                           submit_kw={"deadline_s": 1e-4})
    (rout, rs), (pout, ps) = outs["ref"], outs["port"]
    assert pout[0].kind == rout[0].kind == "deadline"
    _same_stats(rs, ps, "deadline_misses")
    assert ps.stats.deadline_misses == ps.stats.failed == 1


def test_backpressure_reject_mode():
    errs = {}
    for pkg, (mod, _, _) in PKGS.items():
        svc = _service(pkg, batch_size=4, max_delay_s=5.0, max_pending=2,
                       admission="reject")
        try:
            f1 = svc.submit(IMG[pkg], _datas(1)[0])
            f2 = svc.submit(IMG[pkg], _datas(1)[0])
            with pytest.raises(mod.AdmissionError):
                svc.submit(IMG[pkg], _datas(1)[0])
        finally:
            svc.close()
        errs[pkg] = (_outcomes([f1, f2]), svc)
    (rout, rs), (pout, ps) = errs["ref"], errs["port"]
    for k, (r, p) in enumerate(zip(rout, pout)):
        assert_same(r, p, f"job {k}")
    _same_stats(rs, ps)
    assert ps.stats.rejected == 1


def test_backpressure_block_mode_unblocks_on_drain():
    outs = {}
    for pkg in PKGS:
        svc = _service(pkg, batch_size=2, max_delay_s=0.001, max_pending=2,
                       admission="block")
        try:
            futs = [svc.submit(IMG[pkg], d) for d in _datas(2)]
            # the third submit may block until the dispatcher frees
            # capacity; it must return (not raise) and complete
            futs.append(svc.submit(IMG[pkg], _datas(1, seed=9)[0]))
            outs[pkg] = (_outcomes(futs), svc)
        finally:
            svc.close()
    (rout, rs), (pout, ps) = outs["ref"], outs["port"]
    for k, (r, p) in enumerate(zip(rout, pout)):
        assert_same(r, p, f"job {k}")
    _same_stats(rs, ps)
    assert ps.stats.rejected == 0 and ps.stats.completed == 3


def test_close_without_wait_fails_queued_jobs():
    for pkg in PKGS:
        svc = _service(pkg, batch_size=4, max_delay_s=10.0)
        fut = svc.submit(IMG[pkg], _datas(1)[0])
        svc.close(wait=False)
        try:
            fut.result(timeout=60)
        except Exception as e:           # noqa: BLE001 — checked below
            assert e.kind == "shutdown", pkg
        # a dispatch may have squeaked in before close; either way it
        # resolved
        assert fut.done(), pkg
        with pytest.raises(RuntimeError):
            svc.submit(IMG[pkg], _datas(1)[0])


def test_priority_lanes_dispatch_high_priority_first():
    for pkg in PKGS:
        order: list[int] = []
        # batch_size starts larger than the job count so the dispatcher
        # cannot form a cohort while we enqueue; shrinking it afterwards
        # releases cohorts of 2, best priority first
        svc = _service(pkg, batch_size=64, max_delay_s=30.0)
        try:
            futs = []
            for i, d in enumerate(_datas(6)):
                prio = 0 if i == 5 else 1    # last submit, best priority
                f = svc.submit(IMG[pkg], d, priority=prio)
                f.add_done_callback(lambda _, i=i: order.append(i))
                futs.append(f)
            svc.batch_size = 2
            with svc._work:
                svc._work.notify_all()
            for f in futs:
                f.result(timeout=WAIT)
        finally:
            svc.close()
        # the priority-0 job (index 5) rode the first cohort of 2
        assert 5 in order[:2], (pkg, order)


# ---------------------------------------------------------------------------
# Fault plan
# ---------------------------------------------------------------------------

def test_fault_plan_rejects_unknown_site():
    for mod in (rfleet, pfleet):
        with pytest.raises(ValueError):
            mod.FaultPlan(seed=1, not_a_site=1.0)


def test_fault_plan_where_filter_and_count():
    for mod, faults in ((rfleet, rfaults), (pfleet, pfaults)):
        plan = mod.FaultPlan(seed=3, dispatch={"p": 1.0, "count": 2,
                                               "where": {"tier": "blocks"}})
        with plan:
            assert faults.fire("dispatch", tier="superblock") is None
            assert faults.fire("dispatch", tier="blocks") is not None
            assert faults.fire("dispatch", tier="blocks") is not None
            assert faults.fire("dispatch", tier="blocks") is None
        assert plan.injected["dispatch"] == 2
        assert plan.encounters["dispatch"] == 3   # where-misses don't count


def test_fault_plan_deterministic_across_runs():
    def run(mod, faults, seed):
        plan = mod.FaultPlan(seed=seed, dispatch=0.3, compile=0.5)
        with plan:
            pattern = []
            for i in range(50):
                pattern.append(faults.fire("dispatch", k=i) is not None)
                pattern.append(faults.fire("compile", k=i) is not None)
        return pattern, dict(plan.injected)

    for seed in (17, 18):
        assert run(pfleet, pfaults, seed) == run(rfleet, rfaults, seed)
    assert run(pfleet, pfaults, 17) == run(pfleet, pfaults, 17)
    assert run(pfleet, pfaults, 17)[0] != run(pfleet, pfaults, 18)[0]


# ---------------------------------------------------------------------------
# Per-unit tier degradation (compile faults fall down the chain)
# ---------------------------------------------------------------------------

def _drain_with_plan(pkg, plan_kw, datas, **sched_kw):
    mod = PKGS[pkg][0]
    sched = _sched(pkg, batch_size=4, trace=True, **sched_kw)
    hs = [sched.submit(IMG[pkg], d, tdx_dim=32) for d in datas]
    plan = mod.FaultPlan(**plan_kw)
    with plan:
        results = sched.drain()
    return sched, plan, [results[h] for h in hs]


def _degrade_both(plan_kw, datas):
    out = {pkg: _drain_with_plan(pkg, plan_kw, datas) for pkg in PKGS}
    (rsched, rplan, rres), (psched, pplan, pres) = out["ref"], out["port"]
    for k, (r, p) in enumerate(zip(rres, pres)):
        assert_same(r, p, f"job {k}")
    assert pplan.injected == rplan.injected
    assert psched.stats.degraded_units == rsched.stats.degraded_units
    tiers = lambda s: [(e["args"]["from_tier"], e["args"]["to_tier"],
                        e["args"]["error"])
                       for e in s.tracer.events
                       if e["name"] == "tier_degrade"]
    assert tiers(psched) == tiers(rsched)
    return psched, pplan, pres


def test_compile_fault_at_superblock_degrades_to_blocks():
    datas = _datas(4)
    sched, plan, res = _degrade_both(
        dict(seed=1, compile={"p": 1.0, "count": 1,
                              "where": {"tier": "superblock"}}), datas)
    assert plan.injected["compile"] == 1
    assert all(r.tier == "blocks" for r in res)
    for r, ref in zip(res, _refs(datas)):
        assert np.array_equal(r.shared_u32(), ref)
    assert sched.stats.degraded_units == 1
    evs = [e for e in sched.tracer.events if e["name"] == "tier_degrade"]
    assert evs[0]["args"]["from_tier"] == "superblock"
    assert evs[0]["args"]["to_tier"] == "blocks"
    assert evs[0]["args"]["error"] == "InjectedFault"


def test_compile_fault_at_both_tiers_degrades_to_interpreter():
    datas = _datas(4)
    sched, plan, res = _degrade_both(
        dict(seed=1, compile={"p": 1.0, "count": 2}), datas)
    assert plan.injected["compile"] == 2
    assert all(r.tier == "interp" for r in res)
    for r, ref in zip(res, _refs(datas)):
        assert np.array_equal(r.shared_u32(), ref)
    assert sched.stats.degraded_units == 2


def test_dispatch_fault_bisects_and_degrades_per_job():
    """drain_isolated contains a poison dispatch: bisection isolates it,
    the single survivor degrades down the tiers, and the cohort's other
    jobs still deliver bit-identical results."""
    datas = _datas(4)
    out = {}
    for pkg, (mod, _, _) in PKGS.items():
        sched = _sched(pkg, batch_size=4, trace=True)
        hs = [sched.submit(IMG[pkg], d, tdx_dim=32) for d in datas]
        with mod.FaultPlan(seed=2, dispatch={"p": 1.0, "count": 1}):
            results, failures = sched.drain_isolated()
        assert not failures and sorted(results) == sorted(hs), pkg
        out[pkg] = (sched, [results[h] for h in hs])
    (rsched, rres), (psched, pres) = out["ref"], out["port"]
    for k, (r, p, ref) in enumerate(zip(rres, pres, _refs(datas))):
        assert_same(r, p, f"job {k}")
        assert np.array_equal(p.shared_u32(), ref)
    assert psched.stats.bisections == rsched.stats.bisections >= 1
    names = {e["name"] for e in psched.tracer.events}
    assert "batch_bisect" in names and "fault_injected" in names


def test_job_fails_structured_when_every_tier_fails():
    """An unlimited dispatch fault defeats every tier and every retry:
    the future resolves with JobError, the service stays alive."""
    out = {}
    for pkg, (mod, _, _) in PKGS.items():
        out[pkg] = _serve(pkg, _datas(2), batch_size=2, max_delay_s=0.001,
                          faults=mod.FaultPlan(seed=4, dispatch=1.0),
                          max_retries=1, backoff_s=0.001)
    (rout, rs), (pout, ps) = out["ref"], out["port"]
    for k, (r, p) in enumerate(zip(rout, pout)):
        assert_same(r, p, f"job {k}")
        assert p.kind == "error" and p.attempts == 2   # initial + 1 retry
        assert isinstance(p.cause, pfaults.InjectedFault)
    _same_stats(rs, ps, "retries")
    assert ps.stats.failed == ps.stats.retries == 2


def test_device_sync_hang_trips_watchdog_and_recovers():
    datas = _datas(4)
    out = {}
    for pkg, (mod, _, _) in PKGS.items():
        # warm the compiled path first (the port: the plan at batch 4),
        # and time a warm drain: the watchdog must race only the
        # injected hang, never a compile or a slow healthy drain
        sched = _sched(pkg, batch_size=4, compile_min=1, fixed_bucket=True)
        walls = []
        for _ in range(3):
            sched.submit(IMG[pkg], datas[0], tdx_dim=32)
            t0 = time.perf_counter()
            sched.drain()
            walls.append(time.perf_counter() - t0)
        timeout = max(0.3, 10 * min(walls))
        plan = mod.FaultPlan(seed=5, device_sync={
            "p": 1.0, "count": 1, "hang_s": 3 * timeout})
        res, svc = _serve(pkg, datas, batch_size=4, max_delay_s=0.001,
                          faults=plan, dispatch_timeout_s=timeout,
                          max_retries=2, submit_kw={"tdx_dim": 32})
        assert svc.stats.timeouts == 4, pkg       # the whole hung cohort
        assert svc.stats.scheduler_resets == 1, pkg
        out[pkg] = (res, svc)
    (rout, rs), (pout, ps) = out["ref"], out["port"]
    for k, (r, p, ref) in enumerate(zip(rout, pout, _refs(datas))):
        assert_same(r, p, f"job {k}")
        assert np.array_equal(p.shared_u32(), ref)
    _same_stats(rs, ps, "timeouts")


def test_residency_evict_fault_is_harmless():
    datas = _datas(4)
    out = {}
    for pkg, (mod, _, _) in PKGS.items():
        sched = _sched(pkg, batch_size=4)
        plan = mod.FaultPlan(seed=6, residency_evict=1.0)
        with plan:
            hs = [sched.submit(IMG[pkg], d, tdx_dim=32) for d in datas]
            r1 = sched.drain()
            for d in datas:
                sched.submit(IMG[pkg], d, tdx_dim=32)
            sched.drain()
        assert plan.injected["residency_evict"] >= 1, pkg
        assert sched.stats.residency_hits == 0, pkg   # every lookup evicted
        out[pkg] = [r1[h] for h in hs]
    for k, (r, p, ref) in enumerate(zip(out["ref"], out["port"],
                                        _refs(datas))):
        assert_same(r, p, f"job {k}")
        assert np.array_equal(p.shared_u32(), ref)


def test_salvage_corruption_detected_and_reexecuted(monkeypatch):
    """A salvaged result corrupted while stashed fails its delivery
    checksum: it is dropped, its job re-executed, and the caller still
    gets the right answer — corruption costs a re-run, never a wrong
    result."""
    from repro.core.blockc import CompiledProgram as RCompiled

    datas = _datas(6)
    out = {}
    for pkg, cls in (("ref", RCompiled), ("port", CompiledProgram)):
        mod = PKGS[pkg][0]
        sched = _sched(pkg, batch_size=2, trace=True)
        hs = [sched.submit(IMG[pkg], d, tdx_dim=32) for d in datas]
        calls = {"n": 0}
        real = cls.run_light_dev

        def failing(self, shared, tdx, device=None, real=real,
                    calls=calls):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected batch failure")
            return real(self, shared, tdx, device)

        monkeypatch.setattr(cls, "run_light_dev", failing)
        with mod.FaultPlan(seed=7, salvage_corrupt=1.0):
            with pytest.raises(RuntimeError):
                sched.drain()            # stashes 2 results, corrupts 1
        monkeypatch.setattr(cls, "run_light_dev", real)
        results = sched.drain()
        assert sorted(results) == sorted(hs), pkg
        assert sched.stats.salvage_dropped == 1, pkg
        assert sched.stats.salvaged_jobs == 1, pkg   # the intact stash
        assert "salvage_corrupt" in [e["name"] for e in sched.tracer.events]
        out[pkg] = [results[h] for h in hs]
    for k, (r, p, ref) in enumerate(zip(out["ref"], out["port"],
                                        _refs(datas))):
        assert_same(r, p, f"job {k}")
        assert np.array_equal(p.shared_u32(), ref)


# ---------------------------------------------------------------------------
# Chaos soak + serve_jobs convenience
# ---------------------------------------------------------------------------

def test_chaos_soak_every_future_resolves_bit_identical():
    datas = _datas(48)
    refs = _refs(datas)
    out = {}
    for pkg, (mod, _, _) in PKGS.items():
        plan = mod.FaultPlan(seed=23,
                             compile={"p": 1.0, "count": 2},
                             dispatch={"p": 1.0, "count": 2, "after": 1},
                             residency_evict=0.2)
        res, svc = _serve(pkg, datas, batch_size=8, max_delay_s=0.001,
                          faults=plan, max_retries=3, backoff_s=0.001,
                          submit_kw={"tdx_dim": 32})
        assert len(res) == len(datas), pkg      # every future resolved
        assert plan.total_injected() >= 3, pkg
        assert not any(isinstance(o, Exception) for o in res), \
            f"{pkg}: contained faults should salvage every job here"
        out[pkg] = (res, svc)
    (rout, rs), (pout, ps) = out["ref"], out["port"]
    for k, (r, p, ref) in enumerate(zip(rout, pout, refs)):
        assert_same(r, p, f"job {k}", tier=False)
        assert np.array_equal(p.shared_u32(), ref)
    _same_stats(rs, ps)


def test_serve_jobs_orders_outcomes_by_submission():
    datas = _datas(6)
    out = {}
    for pkg, (mod, cfg, extra) in PKGS.items():
        out[pkg] = mod.serve_jobs(
            cfg, [{"image": IMG[pkg], "shared_init": d, "tdx_dim": 32,
                   "tag": k} for k, d in enumerate(datas)],
            batch_size=4, max_delay_s=0.001, **extra)
    assert len(out["port"]) == 6
    for k, (r, p, ref) in enumerate(zip(out["ref"], out["port"],
                                        _refs(datas))):
        assert_same(r, p, f"job {k}")
        assert p.tag == k
        assert np.array_equal(p.shared_u32(), ref)


def test_traced_service_emits_request_pairs_and_serve_events():
    for pkg, report in (("ref", rreport), ("port", preport)):
        mod = PKGS[pkg][0]
        plan = mod.FaultPlan(seed=9, compile={"p": 1.0, "count": 1})
        res, svc = _serve(pkg, _datas(4), batch_size=4, max_delay_s=0.001,
                          trace=True, faults=plan)
        assert not any(isinstance(r, Exception) for r in res), pkg
        events = svc.tracer.events
        req = report.job_latencies(events, name="request")
        assert len(req) == 4 and all(v >= 0 for v in req.values()), pkg
        srv = report.serve_events(events)
        assert srv.get("fault:fault_injected", 0) >= 1, pkg
        assert srv.get("serve:tier_degrade", 0) >= 1, pkg
        text = report.render(events)
        assert "request latency" in text, pkg
        assert "serving / fault events" in text, pkg
