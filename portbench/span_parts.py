"""What the per-layer metrics of the scheduler's and the service's parts
share.  They read the program's tracer events (``ctx["spans"]``) in the
window (``ctx["span_window"]``, microseconds of the tracer's clock):

* the scheduler's spans inside a ``drain``: ``residency`` splits into
  ``digest`` (the inputs' key), ``pack`` (the host image) and ``upload``
  (the copies up, with the args ``bytes`` and ``payload_bytes``), and
  ``collect`` into ``download`` (the copy down) and ``results``;
* a served request's ``request`` async pair, which holds per attempt a
  ``queued`` phase (to the dispatch of its cohort) and a ``run`` phase
  (to its resolution), under the same ``id``.

A reader that finds none of what it reads (a program without these
spans) returns ``None``.
"""
from __future__ import annotations

import numpy as np


def _in_window(ctx) -> list | None:
    """The complete spans inside the window, or ``None`` without one."""
    w = ctx.get("span_window")
    if not w or w[1] is None:
        return None
    return [s for s in ctx.get("spans", []) if s.get("ph") == "X"
            and w[0] <= s["ts"] and s["ts"] + s["dur"] <= w[1]]


def part_share(ctx, name: str) -> float | None:
    """Percent of the window's ``drain`` spans' summed time spent in the
    spans called ``name`` inside them, on the drain's thread."""
    spans = _in_window(ctx)
    if not spans:
        return None
    drains = [s for s in spans if s["name"] == "drain"]
    parts = [s for s in spans if s["name"] == name]
    total = sum(d["dur"] for d in drains)
    if not total or not parts:
        return None
    inner = sum(s["dur"] for d in drains for s in parts
                if s["tid"] == d["tid"] and d["ts"] <= s["ts"]
                and s["ts"] + s["dur"] <= d["ts"] + d["dur"])
    return 100.0 * inner / total


def payload_share(ctx) -> float | None:
    """Percent of the bytes copied up that the jobs carry: the
    ``upload`` spans' ``payload_bytes`` over their ``bytes``."""
    spans = _in_window(ctx)
    if not spans:
        return None
    ups = [s["args"] for s in spans if s["name"] == "upload"
           and "bytes" in s.get("args", {})]
    total = sum(a["bytes"] for a in ups)
    if not total:
        return None
    return 100.0 * sum(a["payload_bytes"] for a in ups) / total


PHASES = ("queued", "run")


def phase_p95_ms(ctx, phase: str) -> float | None:
    """The 95th percentile (numpy, linear), in milliseconds, of the time
    a request spent in ``phase`` summed over its attempts, over the
    requests whose ``request`` pair ended in the window and that show
    any phase."""
    w = ctx.get("span_window")
    if not w or w[1] is None:
        return None
    opened: dict = {}
    summed: dict = {name: {} for name in PHASES}
    ended = []
    for e in ctx.get("spans", []):
        if e.get("cat") != "async":
            continue
        name, key = e["name"], e["id"]
        if name in PHASES:
            if e["ph"] == "b":
                opened[(name, key)] = e["ts"]
            elif e["ph"] == "e" and (name, key) in opened:
                got = summed[name]
                got[key] = got.get(key, 0.0) + e["ts"] \
                    - opened.pop((name, key))
        elif name == "request" and e["ph"] == "e" \
                and w[0] <= e["ts"] <= w[1]:
            ended.append(key)
    vals = [summed[phase].get(k, 0.0) for k in ended
            if any(k in summed[p] for p in PHASES)]
    if not vals:
        return None
    return float(np.percentile(vals, 95)) / 1e3
