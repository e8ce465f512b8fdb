"""The readers of ``span_parts`` on hand-built tracer events, and the
seven per-layer metrics that use them in a traced run of small cells on
the CPU.  A reader that finds none of its spans (a program without
them) gives ``None``."""
import numpy as np
import pytest

from portbench import harness, spec, span_parts
from portbench.test_portbench_faults import SEED, SERVICE, SWEEP

WINDOW = (0.0, 1000.0)


def X(name, ts, dur, tid=0, **args):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def A(name, ph, id, ts):
    return {"name": name, "cat": "async", "ph": ph, "id": id, "ts": ts,
            "args": {}}


def drain(t0):
    """A drain of 100 us at ``t0`` with one batch's parts."""
    return [X("drain", t0, 100.0),
            X("residency", t0 + 5, 60.0),
            X("digest", t0 + 5, 10.0),
            X("pack", t0 + 15, 20.0),
            X("upload", t0 + 35, 30.0, bytes=400, payload_bytes=62),
            X("collect", t0 + 70, 25.0),
            X("download", t0 + 70, 15.0, bytes=400),
            X("results", t0 + 85, 10.0)]


SWEEP_SPANS = (drain(0.0) + drain(200.0)
               # another thread's span inside a drain, and a drain after
               # the window, count nowhere
               + [X("digest", 10.0, 50.0, tid=1)] + drain(2000.0))


def test_part_shares():
    ctx = {"span_window": WINDOW, "spans": SWEEP_SPANS}
    want = {"digest": 10.0, "pack": 20.0, "upload": 30.0, "download": 15.0}
    for name, share in want.items():
        assert span_parts.part_share(ctx, name) == pytest.approx(share)
        got = spec.reader(f"scheduler.{name}_share.sweep")(ctx)
        assert got == pytest.approx(share)


def test_payload_share():
    ctx = {"span_window": WINDOW, "spans": SWEEP_SPANS}
    assert spec.reader("scheduler.payload_share.sweep")(ctx) == \
        pytest.approx(100.0 * 124 / 800)


@pytest.mark.parametrize("name", [
    "scheduler.digest_share.sweep", "scheduler.pack_share.sweep",
    "scheduler.upload_share.sweep", "scheduler.download_share.sweep",
    "scheduler.payload_share.sweep"])
def test_sweep_readers_give_none_without_their_spans(name):
    read = spec.reader(name)
    part = name.split(".")[1].split("_")[0]
    part = "upload" if part == "payload" else part
    # a program whose residency is one span: no part to read
    older = [s for s in SWEEP_SPANS if s["name"] != part]
    assert read({"span_window": WINDOW, "spans": older}) is None
    assert read({"span_window": (0.0, None), "spans": SWEEP_SPANS}) is None
    assert read({"spans": SWEEP_SPANS}) is None
    no_drain = [s for s in SWEEP_SPANS if s["name"] != "drain"]
    if part != "upload" or name.endswith("upload_share.sweep"):
        assert read({"span_window": WINDOW, "spans": no_drain}) is None


def request(id, phases, end):
    """A ``request`` pair from 0 to ``end`` holding ``phases``, each
    ``(name, begin, end)``."""
    evs = [A("request", "b", id, 0.0)]
    for name, b, e in phases:
        evs += [A(name, "b", id, b), A(name, "e", id, e)]
    return evs + [A("request", "e", id, end)]


SERVICE_EVENTS = (
    request(0, [("queued", 0, 10), ("run", 10, 30)], 30)
    # a retry: its phases summed over both attempts
    + request(1, [("queued", 0, 5), ("run", 5, 15), ("queued", 15, 20),
                  ("run", 20, 40)], 40)
    # resolved after the window: not counted
    + request(2, [("queued", 0, 900), ("run", 900, 1500)], 1500)
    # failed while queued: no run
    + request(3, [("queued", 0, 50)], 50)
    + [X("drain", 10.0, 20.0)])


@pytest.mark.parametrize("name,vals", [
    ("service.queue_wait_p95_ms", [10.0, 10.0, 50.0]),
    ("service.run_p95_ms", [20.0, 30.0, 0.0])])
def test_phase_p95(name, vals):
    read = spec.reader(name)
    ctx = {"span_window": WINDOW, "spans": SERVICE_EVENTS}
    assert read(ctx) == pytest.approx(np.percentile(vals, 95) / 1e3)
    # a program whose request pairs hold no phase
    older = [e for e in SERVICE_EVENTS
             if e["name"] not in span_parts.PHASES]
    assert read({"span_window": WINDOW, "spans": older}) is None
    assert read({"span_window": (0.0, None),
                 "spans": SERVICE_EVENTS}) is None
    assert read({"spans": SERVICE_EVENTS}) is None


NEW = ("scheduler.digest_share.sweep", "scheduler.pack_share.sweep",
       "scheduler.upload_share.sweep", "scheduler.download_share.sweep",
       "scheduler.payload_share.sweep", "service.queue_wait_p95_ms",
       "service.run_p95_ms")


@pytest.mark.parametrize("workload,mix,seconds", [
    ("egpu-dp.sweep", SWEEP, 0.3), ("egpu-dp.service", SERVICE, 1.0)])
def test_a_traced_cell_reads_every_new_metric(workload, mix, seconds):
    """Every new metric the cell lists reads a number in a traced run;
    the sweep's lanes fill its batches, so the payload share is its
    programs' words over their shared memories, exactly."""
    out = harness.run_cell(workload, SEED, seconds, True, device="cpu",
                           traffic=mix)
    assert out["correct"], out["checks"]
    listed = [m["name"] for m in spec.cell(spec.load(), workload).per_layer
              if m["name"] in NEW]
    assert listed and all(n in out["metrics"] for n in listed)
    if workload.endswith("sweep"):
        from portbench import programs
        doc = spec.cell(spec.load(), workload).config
        _, progs = programs.load(doc, mix["programs"])
        words = doc["config"]["shared_kb"] * 1024 // 4
        want = 100.0 * sum(p.init_words for p in progs) \
            / (len(progs) * words)
        got = out["metrics"]["scheduler.payload_share.sweep"]["value"]
        assert got == pytest.approx(want, rel=1e-12)
    else:
        assert all(out["metrics"][n]["value"] >= 0 for n in listed)
