"""Offline trace summarizer: ``python -m repro_torch.obs.report trace.json``
(a copy of the reference's framework-free ``repro.obs.report``).

Reads a Chrome trace-event JSON written by
:meth:`repro_torch.obs.trace.Tracer.save` and prints

* the **span tree** — nested spans aggregated by path, with total and
  *self* times (time not covered by child spans) and call counts;
* **coverage** — the fraction of each top-level span's wall time its
  children account for (the CI acceptance bar is >= 95% for ``drain``);
* **counter totals** — the event-counter rollup across the trace;
* the **tier-decision table** — every ``TierPolicy`` choice with the
  feature values and the first rule that fired;
* **job latency** — submit -> deliver percentiles from the async pairs.

``--metrics snapshot.json`` switches to the telemetry view: counters,
gauges, histogram percentiles (lifetime and rolling-window), and the
SLO status a :class:`~repro_torch.obs.metrics.MetricsSnapshot` embeds in its
``meta`` (a snapshot file is auto-detected by its ``kind`` field, so
the flag is optional).

Every section is also available as a plain function for programmatic
use (the obs benchmark gates on :func:`coverage`).
"""
from __future__ import annotations

import argparse
import json
from typing import Any

from .metrics import MetricsSnapshot, _fmt


def load(path: str) -> list[dict]:
    """The trace's event list (accepts both the ``{"traceEvents": []}``
    object form and a bare JSON array)."""
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


# ---------------------------------------------------------------------------
# Span forest reconstruction
# ---------------------------------------------------------------------------

def build_tree(events: list[dict]) -> list[dict]:
    """Rebuild the span forest from flat ``"X"`` events by timestamp
    containment per (pid, tid) track.  Returns root nodes; each node is
    ``{name, ts, dur, args, children}`` with ``dur`` in microseconds."""
    roots: list[dict] = []
    tracks: dict[tuple, list[dict]] = {}
    spans = [e for e in events if e.get("ph") == "X"]
    # children were appended after their parents opened but close first:
    # sorting by (start asc, duration desc) puts every parent before its
    # children, so a simple open-span stack rebuilds the nesting
    spans.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    for e in spans:
        node = {"name": e["name"], "ts": e["ts"],
                "dur": e.get("dur", 0.0), "args": e.get("args", {}),
                "children": []}
        stack = tracks.setdefault((e.get("pid"), e.get("tid")), [])
        while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - 1e-9:
            stack.pop()
        (stack[-1]["children"] if stack else roots).append(node)
        stack.append(node)
    return roots


def _fold(nodes: list[dict], table: dict, path: tuple) -> None:
    for n in nodes:
        key = path + (n["name"],)
        row = table.setdefault(key, {"count": 0, "total": 0.0,
                                     "child": 0.0})
        row["count"] += 1
        row["total"] += n["dur"]
        row["child"] += sum(c["dur"] for c in n["children"])
        _fold(n["children"], table, key)


def span_table(roots: list[dict]) -> list[dict]:
    """Aggregate the forest by name-path: one row per unique nesting
    path with call count, total time, and self time (all in us)."""
    table: dict[tuple, dict] = {}
    _fold(roots, table, ())
    return [{"path": k, "count": v["count"], "total_us": v["total"],
             "self_us": v["total"] - v["child"]}
            for k, v in table.items()]


def coverage(roots: list[dict], name: str = "drain") -> list[float]:
    """Per-instance child coverage of every span called ``name``: the
    fraction of its wall time accounted for by its direct children."""
    out: list[float] = []

    def walk(nodes):
        for n in nodes:
            if n["name"] == name and n["dur"] > 0:
                out.append(sum(c["dur"] for c in n["children"]) / n["dur"])
            walk(n["children"])

    walk(roots)
    return out


# ---------------------------------------------------------------------------
# Non-span sections
# ---------------------------------------------------------------------------

def counter_totals(events: list[dict]) -> dict[str, int]:
    """The trace's final counter rollup (the exporter's
    ``counters_total`` instant), falling back to summing per-drain
    ``drain_counters`` events for partial traces."""
    for e in reversed(events):
        if e.get("name") == "counters_total":
            return dict(e["args"]["counters"])
    totals: dict[str, int] = {}
    for e in events:
        if e.get("name") == "drain_counters":
            for k, v in e.get("args", {}).items():
                if isinstance(v, (int, float)):
                    totals[k] = totals.get(k, 0) + int(v)
    return totals


def tier_decisions(events: list[dict]) -> list[dict]:
    """Every ``TierPolicy`` decision event's args, in trace order."""
    return [dict(e.get("args", {})) for e in events
            if e.get("name") == "tier_decision"]


def job_latencies(events: list[dict],
                  name: str | None = None) -> dict[tuple, float]:
    """``{(name, id): begin -> end latency in us}`` from async pairs.

    The scheduler emits ``job`` pairs (handed to a drain -> delivered);
    the serving layer emits ``request`` pairs (submitted -> future
    resolved, queue wait and retries included) — same id space, distinct
    names, so pairs are keyed by both.  Pass ``name`` to filter."""
    begins: dict[tuple, float] = {}
    lat: dict[tuple, float] = {}
    for e in events:
        if e.get("cat") != "async":
            continue
        if name is not None and e.get("name") != name:
            continue
        key = (e.get("name"), e["id"])
        if e["ph"] == "b":
            begins[key] = e["ts"]
        elif e["ph"] == "e" and key in begins:
            lat[key] = e["ts"] - begins[key]
    return lat


def serve_events(events: list[dict]) -> dict[str, int]:
    """Counts of serving/fault instants (``cat`` in ``serve``/``fault``),
    keyed ``"<cat>:<name>"`` — the at-a-glance robustness story of a
    chaos run (retries, timeouts, degradations, injections...)."""
    out: dict[str, int] = {}
    for e in events:
        if e.get("ph") == "i" and e.get("cat") in ("serve", "fault"):
            k = f"{e['cat']}:{e['name']}"
            out[k] = out.get(k, 0) + 1
    return out


def admission_events(events: list[dict]) -> dict:
    """Static-verifier admission activity: how many submits the
    whole-program analyzer rejected before compile, with the diagnostic
    codes that fired (``admission_lint_reject`` instants from either
    the scheduler or the serving layer)."""
    rejects = 0
    errors = 0
    codes: dict[str, int] = {}
    for e in events:
        if e.get("ph") == "i" and e.get("name") == "admission_lint_reject":
            a = e.get("args", {})
            rejects += 1
            errors += int(a.get("errors", 0))
            for c in str(a.get("codes", "")).split(","):
                if c:
                    codes[c] = codes.get(c, 0) + 1
    return {"rejects": rejects, "errors": errors, "codes": codes}


def _pct(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.3f}s"
    if us >= 1e3:
        return f"{us / 1e3:.3f}ms"
    return f"{us:.1f}us"


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def render(events: list[dict]) -> str:
    roots = build_tree(events)
    lines: list[str] = []

    lines.append("== span tree (count, total, self) ==")
    rows = sorted(span_table(roots), key=lambda r: r["path"])
    if not rows:
        lines.append("  (no spans)")
    for r in rows:
        indent = "  " * len(r["path"])
        lines.append(f"{indent}{r['path'][-1]:<14} x{r['count']:<5} "
                     f"total {_fmt_us(r['total_us']):>10}  "
                     f"self {_fmt_us(r['self_us']):>10}")

    covs = coverage(roots, "drain")
    if covs:
        lines.append("")
        lines.append(f"== drain coverage == {len(covs)} drain(s), child "
                     f"spans cover min {min(covs):.1%} / "
                     f"mean {sum(covs) / len(covs):.1%} of drain wall time")

    totals = counter_totals(events)
    if totals:
        lines.append("")
        lines.append("== counter totals ==")
        for k in sorted(totals):
            lines.append(f"  {k:<24} {totals[k]:>14,}")
        offered = totals.get("lane_steps_offered", 0)
        if offered:
            util = totals.get("lane_steps_active", 0) / offered
            lines.append(f"  {'lane_utilization':<24} {util:>14.1%}")

    decisions = tier_decisions(events)
    if decisions:
        lines.append("")
        lines.append("== tier decisions ==")
        lines.append(f"  {'tier':<11} {'batch':>5} {'disp':>6} "
                     f"{'trace':>6} {'fori':>8}  rule")
        for d in decisions:
            f: dict[str, Any] = d.get("features", {})
            lines.append(
                f"  {d.get('tier', '?'):<11} {d.get('batch', 0):>5} "
                f"{f.get('dispatches', 0):>6} "
                f"{str(f.get('trace_cost')):>6} "
                f"{f.get('fori_execd', 0):>8}  {d.get('rule', '?')}")

    all_lat = job_latencies(events)
    names = sorted({k[0] for k in all_lat})
    for nm in names:
        lat = sorted(v for k, v in all_lat.items() if k[0] == nm)
        label = {"job": "dispatch->deliver",
                 "request": "submit->resolve"}.get(nm, nm)
        lines.append("")
        lines.append(
            f"== {nm} latency == {len(lat)} jobs, {label} "
            f"p50 {_fmt_us(_pct(lat, 0.50))} / "
            f"p90 {_fmt_us(_pct(lat, 0.90))} / "
            f"p99 {_fmt_us(_pct(lat, 0.99))} / max {_fmt_us(lat[-1])}")

    srv = serve_events(events)
    if srv:
        lines.append("")
        lines.append("== serving / fault events ==")
        for k in sorted(srv):
            lines.append(f"  {k:<32} {srv[k]:>8,}")

    adm = admission_events(events)
    if adm["rejects"]:
        lines.append("")
        lines.append("== static-verifier admission ==")
        lines.append(f"  {'programs rejected':<32} {adm['rejects']:>8,}")
        lines.append(f"  {'ERROR diagnostics':<32} {adm['errors']:>8,}")
        for c in sorted(adm["codes"]):
            lines.append(f"  {'code: ' + c:<32} {adm['codes'][c]:>8,}")

    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Metrics-snapshot rendering
# ---------------------------------------------------------------------------

def _fmt_s(seconds: float | None) -> str:
    if seconds is None:
        return "-"
    return _fmt_us(seconds * 1e6)


def render_metrics(snap: MetricsSnapshot) -> str:
    """Human-readable view of a :class:`MetricsSnapshot`: counters and
    gauges (per label set), histogram percentiles (lifetime and, when a
    rolling window was configured, windowed), and the embedded SLO
    status from ``meta``."""
    lines: list[str] = []

    scalars = [m for m in snap.metrics if m["type"] in ("counter", "gauge")]
    if scalars:
        lines.append("== counters / gauges ==")
        for m in sorted(scalars, key=lambda m: m["name"]):
            for s in m["samples"]:
                lab = ",".join(f"{k}={v}"
                               for k, v in sorted(s["labels"].items()))
                tag = f"{m['name']}{{{lab}}}" if lab else m["name"]
                lines.append(f"  {tag:<56} {_fmt(s['value']):>12}")

    hists = [m for m in snap.metrics if m["type"] == "histogram"]
    for m in sorted(hists, key=lambda m: m["name"]):
        lines.append("")
        lines.append(f"== {m['name']} ==")
        for s in m["samples"]:
            lab = ",".join(f"{k}={v}"
                           for k, v in sorted(s["labels"].items()))
            flt = dict(s["labels"])
            n = s["count"]
            mean = s["sum"] / n if n else 0.0
            row = (f"  {{{lab}}}" if lab else "  (all)")
            row = (f"{row:<36} n={n:<8} mean {_fmt_s(mean):>9} "
                   f"p50 {_fmt_s(snap.percentile(m['name'], .5, **flt)):>9}"
                   f" p99 "
                   f"{_fmt_s(snap.percentile(m['name'], .99, **flt)):>9}")
            if "window" in s:
                wn = s["window"]["count"]
                wp99 = snap.percentile(m["name"], .99, window=True, **flt)
                row += (f"  | window({_fmt(s['window']['span_s'])}s) "
                        f"n={wn} p99 {_fmt_s(wp99)}")
            lines.append(row)

    slo = snap.meta.get("slo")
    if slo:
        lines.append("")
        lines.append("== SLO status ==")
        for k in sorted(slo):
            v = slo[k]
            if (k.endswith("_s") and isinstance(v, float)
                    and k not in ("window_s", "slo_latency_s")):
                v = _fmt_s(v)            # latency keys read best scaled
            lines.append(f"  {k:<24} {v}")
    for k, v in sorted(snap.meta.items()):
        if k != "slo":
            lines.append(f"  meta.{k}: {v}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a repro_torch.obs Chrome/Perfetto trace or "
                    "metrics snapshot.")
    ap.add_argument("trace", help="trace JSON written with --trace / "
                                  "Tracer.save(), or a metrics snapshot "
                                  "written with MetricsSnapshot.save()")
    ap.add_argument("--metrics", action="store_true",
                    help="force the metrics-snapshot view (auto-detected "
                         "from the file's kind field otherwise)")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    is_snap = args.metrics or (
        isinstance(doc, dict) and doc.get("kind") == "repro.obs.metrics")
    if is_snap:
        print(render_metrics(MetricsSnapshot.from_json(doc)))
    else:
        print(render(doc["traceEvents"] if isinstance(doc, dict) else doc))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
