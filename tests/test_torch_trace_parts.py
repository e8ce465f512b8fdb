"""The parts of the port's fleet path that its tracer shows, on the CPU.

A compiled batch's ``residency`` span holds ``digest`` (the inputs'
key) and, on a miss, ``pack`` (the zeroed host image) and ``upload``
(the copies up, with ``bytes`` of the image and ``payload_bytes`` of
the real jobs' words); its ``collect`` span holds ``download`` (the
copy down, with ``bytes``) and ``results``.  The sharded fleet's
megabatches show the same parts.  The per-drain ``drain_counters``
rollup sums each distinct counter block once, times its jobs, and
equals the per-job sum.  A traced ``FleetService`` nests, per attempt,
a ``queued`` and a ``run`` phase in each ``request`` pair.  Without a
tracer none of this is recorded.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port as tp  # noqa: E402
from repro_torch import programs as tprog  # noqa: E402
from repro_torch.core import Asm, EGPUConfig  # noqa: E402
from repro_torch.fleet import (FaultPlan, Fleet, FleetService,  # noqa: E402
                               ShardedFleetScheduler)
from repro_torch.fleet import service as service_mod  # noqa: E402
from repro_torch.obs import aggregate, report  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

CFG = tp.config(EGPUConfig, "dp")
#: the paper's 128 KB of shared memory, so a batch's host work is large
#: against the spans' own cost
BIG = EGPUConfig(**{**tp.CFG_KW, "shared_kb": 128})
WAIT = 300


def _loop_prog(cfg, iters=4):
    a = Asm(cfg)
    a.tdx(1)
    a.lod(2, 1, 0)
    with a.loop(iters):
        a.fadd(2, 2, 2)
    a.sto(2, 1, 0)
    a.stop()
    return a.assemble(threads_active=32)


def _datas(n, words=32, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(words).astype(np.float32)
            for _ in range(n)]


def _nodes(events, name):
    """Every node of the span tree called ``name``."""
    out = []

    def walk(ns):
        for n in ns:
            if n["name"] == name:
                out.append(n)
            walk(n["children"])
    walk(report.build_tree(events))
    return out


def _kids(node):
    return [c["name"] for c in node["children"]]


def test_residency_and_collect_show_their_parts():
    """A miss is digest, pack, upload; a hit is digest alone; collect is
    download, results; the parts cover the spans they split."""
    b = tprog.build_reduction(BIG, 32)
    fleet = Fleet(BIG, batch_size=256, trace=True, device="cpu")
    for _ in range(2):                   # a miss, then a hit
        for _ in range(256):
            fleet.submit(b.image, b.shared_init, tdx_dim=b.tdx_dim)
        fleet.drain()
    events = fleet.tracer.events
    res = _nodes(events, "residency")
    assert [r["args"]["hit"] for r in res] == [False, True]
    assert _kids(res[0]) == ["digest", "pack", "upload"]
    assert _kids(res[1]) == ["digest"]
    collects = _nodes(events, "collect")
    assert len(collects) == 2
    assert all(_kids(c) == ["download", "results"] for c in collects)
    assert all(c["children"][0]["args"]["bytes"] == 256 * BIG.shared_words
               * 4 for c in collects)
    roots = report.build_tree(events)
    misses = [n for n in roots[0]["children"][-1]["children"]
              if n["name"] == "residency"]
    assert misses and min(report.coverage(misses, "residency")) >= 0.95
    assert min(report.coverage(roots, "collect")) >= 0.95


def test_upload_counts_the_image_and_the_real_jobs_words():
    """``bytes`` is the whole ``(B, S)`` image; ``payload_bytes`` the
    real jobs' words, the filler lanes of a pow2 bucket counting 0."""
    img = _loop_prog(CFG)
    fleet = Fleet(CFG, batch_size=4, trace=True, device="cpu")
    datas = [np.zeros(32, np.float32), np.zeros(20, np.float32),
             np.zeros(7, np.float32)]
    hs = [fleet.submit(img, d, tdx_dim=32) for d in datas]
    assert sorted(fleet.drain()) == hs
    (up,) = [e for e in fleet.tracer.events if e["name"] == "upload"]
    assert up["args"]["bytes"] == 4 * CFG.shared_words * 4   # 3 -> bucket 4
    assert up["args"]["payload_bytes"] == (32 + 20 + 7) * 4


def test_sharded_megabatch_shows_the_same_parts():
    devs = [torch.device("cpu", i) for i in range(4)]
    img = _loop_prog(CFG)
    sh = ShardedFleetScheduler(CFG, batch_size=2, devices=devs, trace=True)
    datas = _datas(8)
    for _ in range(2):
        hs = [sh.submit(img, d, tdx_dim=32) for d in datas]
        assert sorted(sh.drain()) == hs
    assert sh._mega_residency.hits == 1
    events = sh.tracer.events
    res = _nodes(events, "residency")
    assert [_kids(r) for r in res] == [["digest", "pack", "upload"],
                                       ["digest"]]
    up = res[0]["children"][2]["args"]
    assert up == {"bytes": 8 * CFG.shared_words * 4,
                  "payload_bytes": 8 * 32 * 4}
    collects = _nodes(events, "collect")
    assert [_kids(c) for c in collects] == [["download", "results"]] * 2
    assert collects[0]["children"][0]["args"]["bytes"] == \
        8 * CFG.shared_words * 4


def test_drain_counters_roll_up_per_block_as_per_job():
    """A mixed drain (two compiled programs, one interpreter job): the
    rollup of each distinct block times its jobs equals the per-job
    sum, in the event and in the tracer's running totals."""
    progs = [_loop_prog(CFG, 4), _loop_prog(CFG, 6), _loop_prog(CFG, 9)]
    fleet = Fleet(CFG, batch_size=4, trace=True, device="cpu",
                  compile_min=2)
    for img, n in zip(progs, (5, 3, 1)):
        for d in _datas(n):
            fleet.submit(img, d, tdx_dim=32)
    results = fleet.drain()
    assert {r.tier for r in results.values()} >= {"interp"}
    want = aggregate(r.counters for r in results.values()).flat()
    (ev,) = [e for e in fleet.tracer.events
             if e["name"] == "drain_counters"]
    assert ev["args"] == want
    assert fleet.tracer.counters == want
    blocks = {id(r.counters) for r in results.values()}
    assert len(blocks) < len(results)     # the rollup had jobs to share


def _phases(events):
    """``{id: [(name, ph, ts)]}`` of the request pairs and their phases,
    in trace order."""
    out: dict = {}
    for e in events:
        if e.get("cat") == "async" and e["name"] in ("request", "queued",
                                                     "run"):
            out.setdefault(e["id"], []).append((e["name"], e["ph"],
                                                e["ts"]))
    return out


def _serve(n, **kw):
    svc = FleetService(CFG, batch_size=4, max_delay_s=0.001, device="cpu",
                       **kw)
    try:
        futs = [svc.submit(_loop_prog(CFG), d, tdx_dim=32)
                for d in _datas(n)]
        out = []
        for f in futs:
            try:
                out.append(f.result(timeout=WAIT))
            except Exception as e:       # noqa: BLE001 — compared below
                out.append(e)
    finally:
        svc.close()
    return out, svc


def test_service_nests_one_queued_and_one_run_phase_a_request():
    out, svc = _serve(6, trace=True)
    assert not any(isinstance(r, Exception) for r in out)
    phases = _phases(svc.tracer.events)
    assert len(phases) == 6
    for evs in phases.values():
        assert [(n, ph) for n, ph, _ in evs] == [
            ("request", "b"), ("queued", "b"), ("queued", "e"),
            ("run", "b"), ("run", "e"), ("request", "e")]
        ts = [t for _, _, t in evs]
        assert ts[0] == ts[1] and ts[2] == ts[3] and ts[4] == ts[5]
        assert ts == sorted(ts)


def test_a_retried_request_has_a_phase_pair_an_attempt():
    out, svc = _serve(1, trace=True, faults=FaultPlan(seed=4, dispatch=1.0),
                      max_retries=1, backoff_s=0.001)
    assert out[0].kind == "error" and out[0].attempts == 2
    (evs,) = _phases(svc.tracer.events).values()
    assert [(n, ph) for n, ph, _ in evs] == [
        ("request", "b"), ("queued", "b"), ("queued", "e"), ("run", "b"),
        ("run", "e"), ("queued", "b"), ("queued", "e"), ("run", "b"),
        ("run", "e"), ("request", "e")]
    ts = [t for _, _, t in evs]
    assert ts == sorted(ts)
    lat = report.job_latencies(svc.tracer.events)
    assert {("queued", 0), ("run", 0), ("request", 0)} <= set(lat)


def test_nothing_is_recorded_without_a_tracer(monkeypatch):
    """No tracer and no flight recorder: no live span, no async event,
    no phase bookkeeping; with the service's own recorder on, its ring
    holds the scheduler's spans but no request phase."""
    def refuse(*a, **k):
        raise AssertionError("recorded without a tracer")
    monkeypatch.setattr(obs_trace._Span, "__init__", refuse)
    monkeypatch.setattr(obs_trace.Tracer, "async_begin", refuse)
    monkeypatch.setattr(obs_trace.Tracer, "async_end", refuse)
    monkeypatch.setattr(service_mod.FleetService, "_phase", refuse)
    img = _loop_prog(CFG)
    fleet = Fleet(CFG, batch_size=4, device="cpu")
    hs = [fleet.submit(img, d, tdx_dim=32) for d in _datas(3)]
    assert sorted(fleet.drain()) == hs
    out, _ = _serve(4, telemetry=False)
    assert not any(isinstance(r, Exception) for r in out)
    monkeypatch.undo()
    monkeypatch.setattr(service_mod.FleetService, "_phase", refuse)
    out, svc = _serve(4)
    assert not any(isinstance(r, Exception) for r in out)
    names = {r["name"] for r in svc.recorder.tail()}
    assert "upload" in names and not names & {"queued", "run", "request"}
