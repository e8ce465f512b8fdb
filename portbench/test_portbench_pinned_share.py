"""``scheduler.pinned_download_share.sweep`` on hand-built tracer events
and in a traced run of a small sweep on the CPU.  A program whose
``download`` spans lack ``pinned_bytes`` gives ``None``."""
import pytest

from portbench import harness, spec
from portbench.test_portbench_faults import SEED, SWEEP
from portbench.test_portbench_span_parts import SWEEP_SPANS, WINDOW, X

NAME = "scheduler.pinned_download_share.sweep"


def pinned(spans, *pinned_bytes):
    """``spans`` with each ``download`` span in turn given the next of
    ``pinned_bytes``."""
    it = iter(pinned_bytes)
    return [X(s["name"], s["ts"], s["dur"], s["tid"],
              **s["args"], pinned_bytes=next(it))
            if s["name"] == "download" else s for s in spans]


def test_pinned_share_reads_pinned_over_all_bytes_in_the_window():
    read = spec.reader(NAME)
    # three downloads of 400 bytes, the last after the window
    spans = pinned(SWEEP_SPANS, 400, 100, 0)
    assert read({"span_window": WINDOW, "spans": spans}) == \
        pytest.approx(100.0 * 500 / 800)
    every = pinned(SWEEP_SPANS, 400, 400, 400)
    assert read({"span_window": WINDOW, "spans": every}) == 100.0
    assert read({"span_window": WINDOW,
                 "spans": pinned(SWEEP_SPANS, 0, 0, 0)}) == 0.0


def test_pinned_share_gives_none_without_the_arg():
    read = spec.reader(NAME)
    assert read({"span_window": WINDOW, "spans": SWEEP_SPANS}) is None
    spans = pinned(SWEEP_SPANS, 400, 400, 400)
    assert read({"span_window": (0.0, None), "spans": spans}) is None
    assert read({"spans": spans}) is None
    assert read({"span_window": WINDOW,
                 "spans": [s for s in spans
                           if s["name"] != "download"]}) is None


def test_a_traced_cpu_sweep_pins_nothing():
    """On the CPU nothing comes down from a card: the metric reads 0."""
    out = harness.run_cell("egpu-dp.sweep", SEED, 0.3, True, device="cpu",
                           traffic=SWEEP)
    assert out["correct"], out["checks"]
    assert out["metrics"][NAME]["value"] == 0.0
