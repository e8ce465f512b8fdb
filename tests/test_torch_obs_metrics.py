"""The port's device-free observability and paper models against the JAX
package's, on the CPU: the device-free parts of ``test_metrics.py`` and
``test_obs.py``, the fault plans of ``fleet/faults.py``, and
``test_area_model.py``.

* ``obs.metrics``: the same calls on both packages' registries give the
  same totals, percentiles, windows, SLO burn, JSON and Prometheus text
  (tolerance: none; the snapshot format is shared, so each package
  loads the other's file), and the registry's own contracts hold;
* ``obs.report``: the same snapshot renders the same text, and the
  report reads the port's traced drain;
* ``fleet.faults``: one seed and encounter order inject the same faults
  in both packages;
* ``core.area_model`` and ``core.nios_model``: the same resources, Fmax
  and Nios cycle counts for every configuration of Tables 4 and 5, and
  the paper checks of ``test_area_model.py``.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro.core import area_model as ref_area  # noqa: E402
from repro.core import nios_model as ref_nios  # noqa: E402
from repro.core import table4_configs as ref_t4  # noqa: E402
from repro.core import table5_configs as ref_t5  # noqa: E402
from repro.fleet import faults as ref_faults  # noqa: E402
from repro.obs import metrics as ref_metrics  # noqa: E402
from repro.obs import report as ref_report  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402
from repro_torch.core import (EGPUConfig, area_model, nios_model,  # noqa: E402
                              resources, table4_configs, table5_configs)
from repro_torch.core.area_model import PAPER_TABLE4, PAPER_TABLE5  # noqa: E402
from repro_torch.fleet import FAULT_SITES, Fleet, faults  # noqa: E402
from repro_torch.obs import metrics, report  # noqa: E402
from repro_torch.obs.metrics import (DEFAULT_TIME_BUCKETS,  # noqa: E402
                                     MetricsRegistry, MetricsSnapshot)
from repro_torch.obs.recorder import FlightRecorder  # noqa: E402

# ---------------------------------------------------------------------------
# the registry: the same calls, the same numbers and text
# ---------------------------------------------------------------------------


def _scenario(mod):
    """Drive one registry through every primitive; returns what a
    caller reads back."""
    clk = {"t": 0.0}
    reg = mod.MetricsRegistry(clock=lambda: clk["t"])
    reg.inc("jobs_total", 3, tier="interp", program="p0")
    reg.inc("jobs_total", 4, tier="blocks", program="p0")
    reg.inc("jobs_total", 5, tier="blocks", program="p1")
    reg.set_gauge("depth", 7)
    reg.set_gauge("depth", 3)
    reg.histogram("req_seconds", labelnames=("outcome",), window_s=6.0)
    rng = np.random.default_rng(11)
    for v in rng.uniform(0.001, 0.5, 200):
        reg.observe("req_seconds", float(v), outcome="ok")
    clk["t"] = 3.0
    for v in (2.0, 0.001, 100.0):
        reg.observe("req_seconds", v, outcome="error")
    clk["t"] = 8.0
    snap = reg.snapshot()
    snap.meta["slo"] = {"burn": 0.5}
    out = {
        "totals": [reg.total("jobs_total"),
                   reg.total("jobs_total", tier="blocks"),
                   reg.total("jobs_total", tier="blocks", program="p1"),
                   reg.total("jobs_total", tier="nope"),
                   reg.total("missing_total")],
        "gauge": reg.value("depth"),
        "pct": [snap.percentile("req_seconds", q) for q in (0.5, 0.9, 0.99)],
        "pct_window": snap.percentile("req_seconds", 0.5, window=True),
        "count": [snap.hist_count("req_seconds"),
                  snap.hist_count("req_seconds", window=True)],
        "count_le": [snap.count_le("req_seconds", x)
                     for x in (0.05, 0.04, 1.0)],
        "burn": snap.slo_burn("req_seconds", threshold_s=0.1, target=0.99,
                              good_filter={"outcome": "ok"}),
        "prom": reg.to_prometheus(),
        "json": json.dumps({k: v for k, v in snap.to_json().items()
                            if k != "ts"}, sort_keys=True),   # wall time
    }
    return out


def test_registry_reads_as_the_reference():
    assert _scenario(metrics) == _scenario(ref_metrics)
    assert DEFAULT_TIME_BUCKETS == ref_metrics.DEFAULT_TIME_BUCKETS


def test_snapshots_load_across_packages(tmp_path):
    reg = MetricsRegistry()
    reg.inc("jobs_total", 5, tier="blocks")
    for v in (0.001, 0.02, 0.3):
        reg.observe("lat_seconds", v, outcome="ok")
    path = reg.snapshot().save(tmp_path / "snap.json")
    back = ref_metrics.MetricsSnapshot.load(path)
    assert back.to_prometheus() == reg.to_prometheus()
    again = MetricsSnapshot.load(back.save(tmp_path / "ref.json"))
    assert again.total("jobs_total") == 5
    assert 'lat_seconds_bucket{le="+Inf",outcome="ok"} 3' in \
        again.to_prometheus()
    with pytest.raises(ValueError):
        MetricsSnapshot.from_json({"kind": "nope"})


def test_counter_gauge_errors():
    reg = MetricsRegistry()
    reg.inc("a_total", 2)
    with pytest.raises(ValueError):
        reg.inc("a_total", -1)                   # counters are monotonic
    with pytest.raises(ValueError):
        reg.gauge("a_total")                     # kind conflict
    reg.counter("b_total", labelnames=("x",))
    with pytest.raises(ValueError):
        reg.counter("b_total", labelnames=("y",))
    with pytest.raises(ValueError):
        reg.inc("b_total")                       # missing label value


def test_registry_thread_safety_exact_counts():
    reg = MetricsRegistry()
    reg.counter("c_total", labelnames=("w",))
    reg.histogram("h_seconds")
    n_threads, n_iter = 8, 500

    def work(w):
        for i in range(n_iter):
            reg.inc("c_total", w=w)
            reg.inc("c_total", w="all")
            reg.observe("h_seconds", 0.001 * (i % 7 + 1))

    ths = [threading.Thread(target=work, args=(str(k),))
           for k in range(n_threads)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ths)
    assert reg.total("c_total", w="all") == n_threads * n_iter
    assert reg.total("c_total") == 2 * n_threads * n_iter
    assert reg.snapshot().hist_count("h_seconds") == n_threads * n_iter


def test_ambient_helpers_no_op_without_registry():
    metrics.inc("never_total")
    metrics.observe("never_seconds", 1.0)
    metrics.set_gauge("never", 1.0)
    assert metrics.current_registry() is None
    reg = MetricsRegistry()
    with reg.installed():
        assert metrics.current_registry() is reg
        assert ref_metrics.current_registry() is None   # separate ambients
        metrics.inc("seen_total", 2)
    assert metrics.current_registry() is None
    assert reg.value("seen_total") == 2


def test_report_renders_metrics_as_the_reference(tmp_path):
    texts = []
    for mod, rep in ((ref_metrics, ref_report), (metrics, report)):
        reg = mod.MetricsRegistry()
        reg.inc("serve_submitted_total", 5, priority=1)
        reg.set_gauge("serve_queue_depth", 3)
        reg.histogram("serve_request_latency_seconds",
                      labelnames=("outcome",), window_s=60.0)
        for v in (0.001, 0.02, 0.3):
            reg.observe("serve_request_latency_seconds", v, outcome="ok")
        snap = reg.snapshot()
        snap.meta["slo"] = {"window_s": 60.0, "burn": 0.25,
                            "request_p99_s": 0.29}
        texts.append(rep.render_metrics(snap))
        path = snap.save(tmp_path / f"{mod.__name__}.json")
        assert report.main([str(path)]) == 0
        assert report.main(["--metrics", str(path)]) == 0
    assert texts[0] == texts[1]
    assert "SLO status" in texts[1] and "serve_queue_depth" in texts[1]


# ---------------------------------------------------------------------------
# the flight recorder and the traced fleet
# ---------------------------------------------------------------------------

def test_recorder_ring_bounded_and_filtered():
    rec = FlightRecorder(capacity=16)
    for i in range(100):
        rec.record("e", i=i)
    assert len(rec) == 16 and rec.recorded == 100
    assert [r["args"]["i"] for r in rec.tail(4)] == [96, 97, 98, 99]
    rec = FlightRecorder(capacity=64)
    rec.record("dispatch", jobs=4)
    rec.record("job_retry", id=7)
    rec.record("job_retry", id=9)
    names = [(r["name"], r["args"].get("id")) for r in rec.recent_for(7)]
    assert ("dispatch", None) in names and ("job_retry", 7) in names
    assert ("job_retry", 9) not in names


def test_recorder_dump_rate_limit_and_loadable_json(tmp_path):
    rec = FlightRecorder(capacity=32, blackbox_dir=str(tmp_path), label="t")
    rec.record("before", k=1)
    p1 = rec.dump("unit_test", extra="x")
    assert p1 is not None
    assert rec.dump("unit_test") is None         # rate-limited
    assert rec.dump("unit_test", force=True) is not None
    assert rec.dump("other_reason") is not None
    with open(p1) as f:
        doc = json.load(f)
    assert "before" in [e["name"] for e in doc["traceEvents"]]
    assert doc["otherData"]["reason"] == "unit_test"
    assert len(rec.dumps) == 3


def test_traced_drain_reports_and_stats_are_registry_views(tmp_path,
                                                           monkeypatch):
    """The port's traced drain feeds the report (span tree, tier
    decisions, counter totals), the flight recorder sees its events,
    and ``FleetStats`` reads the registry it exports.  The drain gets a
    compile cache of its own, so its programs are compiled (and their
    tiers decided) inside the trace whatever ran before in the
    process."""
    from repro_torch.core import blockc
    monkeypatch.setattr(blockc, "_CACHE", {})
    cfg = tp.config(EGPUConfig, "dp")
    benches = [tprog.build_reduction(cfg, 32), tprog.build_matmul(cfg, 8)]
    rec = FlightRecorder(capacity=256)
    fleet = Fleet(cfg, batch_size=4, trace=str(tmp_path / "t.json"),
                  device="cpu")
    for b in benches * 2:
        fleet.submit(b.image, b.shared_init, tdx_dim=b.tdx_dim)
    with rec.installed():
        fleet.drain()
    events = report.load(str(tmp_path / "t.json"))
    assert report.tier_decisions(events)
    assert report.counter_totals(events)["instrs"] > 0
    assert "drain" in report.render(events)
    assert any(r["name"] == "tier_group" for r in rec.tail())
    st, reg = fleet.stats, fleet.metrics
    assert st.jobs == 4 == int(reg.total("fleet_jobs_total"))
    assert st.compiled_batches == int(
        reg.total("fleet_batches_total", tier="blocks")
        + reg.total("fleet_batches_total", tier="superblock"))
    text = reg.to_prometheus()
    assert "fleet_jobs_total{" in text


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

def _fault_log(mod):
    plan = mod.FaultPlan(seed=9, compile=0.5,
                         dispatch={"p": 0.3, "count": 4, "after": 1},
                         device_sync={"hang_s": 0.25, "count": 1},
                         residency_evict={"where": {"tier": "blocks"}})
    hangs, raised = [], 0
    with plan:
        for i in range(40):
            for tier in ("blocks", "superblock"):
                try:
                    mod.maybe_raise("dispatch", tier=tier, i=i)
                except mod.InjectedFault:
                    raised += 1
                mod.fire("compile", tier=tier)
                mod.fire("residency_evict", tier=tier)
            hangs.append(mod.hang_seconds("device_sync", i=i))
    assert mod.current_plan() is None
    return plan.log, plan.encounters, plan.injected, hangs, raised


def test_fault_plans_inject_as_the_reference():
    assert FAULT_SITES == ref_faults.FAULT_SITES
    assert _fault_log(faults) == _fault_log(ref_faults)
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.FaultPlan(dispach=1.0)
    assert faults.fire("dispatch") is None       # no ambient plan


# ---------------------------------------------------------------------------
# the paper models
# ---------------------------------------------------------------------------

def _configs():
    return [(k, c, ref_t4()[k]) for k, c in table4_configs().items()] + \
        [(k, c, ref_t5()[k]) for k, c in table5_configs().items()]


@pytest.mark.parametrize("name,cfg,rcfg", _configs(),
                         ids=[k for k, _, _ in _configs()])
def test_area_model_equals_the_reference(name, cfg, rcfg):
    assert dataclasses.asdict(resources(cfg)) == \
        dataclasses.asdict(ref_area.resources(rcfg))
    for fn in ("m20k_registers", "m20k_shared", "m20k_instructions"):
        assert getattr(area_model, fn)(cfg) == getattr(ref_area, fn)(rcfg)


@pytest.mark.parametrize("name", list(PAPER_TABLE4))
def test_table4(name):
    r = resources(table4_configs()[name])
    alm, ff, dsp, m20k, _soft, fmax = PAPER_TABLE4[name]
    assert (r.m20ks, r.dsps, r.fmax_mhz) == (m20k, dsp, fmax)
    assert abs(r.alms - alm) / alm < 0.15
    assert abs(r.ffs - ff) / ff < 0.20


@pytest.mark.parametrize("name", list(PAPER_TABLE5))
def test_table5_qp(name):
    r = resources(table5_configs()[name])
    alm, _ff, dsp, m20k, _soft, _fmax = PAPER_TABLE5[name]
    assert abs(r.m20ks - m20k) <= 1
    assert r.dsps == dsp and r.fmax_mhz == 600.0
    assert abs(r.alms - alm) / alm < 0.30


def test_qp_halving_predicates_and_normalized_cost():
    small = EGPUConfig(memory_mode="qp", max_threads=512,
                       regs_per_thread=16, shared_kb=8)
    dp = small.replace(memory_mode="dp")
    assert area_model.m20k_registers(small) == area_model.m20k_registers(dp)
    base = EGPUConfig(alu_bits=16, shift_bits=16, alu_features="full",
                      predicate_levels=0, shared_kb=32)
    ratio = resources(base.replace(predicate_levels=5)).alms \
        / resources(base).alms
    assert 1.25 < ratio < 1.75
    assert area_model.NIOS_ALMS + 100 * area_model.NIOS_DSPS == 1400
    r = resources(table4_configs()["medium_dp_b"])
    assert 7000 < r.normalized_cost < 16000


def test_nios_model_equals_the_reference():
    assert nios_model.PAPER_NIOS == ref_nios.PAPER_NIOS
    for bench in nios_model._PER_ELEM:
        for n in (32, 64, 128, 256):
            assert nios_model.cycles(bench, n) == ref_nios.cycles(bench, n)
            assert nios_model.time_us(bench, n) == \
                ref_nios.time_us(bench, n)
