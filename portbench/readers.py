"""What the per-layer metrics of ``metrics/`` share: each of those files
is one metric's ``read(ctx)``, and most are a line over these.

``ctx`` is what a traced run gathered: ``spans`` (the program's tracer
events), ``span_window`` (the window on the tracer's clock, in
microseconds), ``profile`` (:func:`portbench.profiling.read` of the
profiled slice), ``graph_stats`` (each program's plan at the cell's
width), ``tiers`` (jobs by tier), ``steps`` and ``drains`` (a sweep),
``lane_jobs`` (a service's real jobs and pad slots), ``system`` (what
the system's ``load`` gave: for the eGPU the reference's ``core`` and
``progs``), ``traffic`` and ``workload``.
A reader that finds nothing to read returns ``None``.
"""
from __future__ import annotations

from . import roofline


def host_share(ctx) -> float | None:
    """Percent of the window's ``drain`` spans not covered by their
    ``dispatch`` and ``device_sync`` spans: the scheduler's host work."""
    w = ctx.get("span_window")
    if not w or w[1] is None:
        return None
    spans = [s for s in ctx["spans"] if s.get("ph") == "X"
             and w[0] <= s["ts"] and s["ts"] + s["dur"] <= w[1]]
    drains = [s for s in spans if s["name"] == "drain"]
    total = sum(s["dur"] for s in drains)
    if not total:
        return None
    inner = 0.0
    for d in drains:
        end = d["ts"] + d["dur"]
        kids = sorted((s["ts"], s["ts"] + s["dur"]) for s in spans
                      if s["name"] in ("dispatch", "device_sync")
                      and s["tid"] == d["tid"] and d["ts"] <= s["ts"]
                      and s["ts"] + s["dur"] <= end)
        edge = d["ts"]
        for a, b in kids:
            inner += max(0.0, b - max(a, edge))
            edge = max(edge, b)
    return 100.0 * (total - inner) / total


def idle(ctx) -> float | None:
    """Percent of the profiled slice in which no device op ran."""
    p = ctx.get("profile")
    if not p or p["window_s"] <= 0 or p["n_device"] == 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def kernel_roofline(ctx, kernel: str) -> float | None:
    """Percent of ``kernel``'s roofline over the profiled slice: the
    least time of the launches its batches needed, from their shapes
    (:func:`portbench.roofline.path_work`), over the device time the
    profiler gave that kernel."""
    p, batches = ctx.get("profile"), ctx.get("profiled_batches")
    if not p or not batches or kernel not in p["hand"]:
        return None
    progs, core = ctx["system"].progs, ctx["system"].core
    works = [roofline.path_work(core, progs[i].path, progs[i].threads,
                                cores)[kernel] for i, cores in batches]
    launches, least = roofline.summed(works)
    return roofline.share(least, launches, p["hand"][kernel])


def _device_total(p) -> float:
    """Seconds of every device op of the slice, summed."""
    return sum(s for s, _ in p["ops"].values())


def torch_op_share(ctx) -> float | None:
    """Percent of the device ops' time in kernels other than the port's
    hand kernels: the compiled tiers' torch-op rows.  Copies and fills
    are :func:`copy_share`'s."""
    p = ctx.get("profile")
    if not p or _device_total(p) <= 0:
        return None
    hand = sum(s for s, _ in p["hand"].values())
    return 100.0 * (p["by_cat"].get("kernel", 0.0) - hand) \
        / _device_total(p)


def copy_share(ctx) -> float | None:
    """Percent of the device ops' time in copies and fills (the inputs'
    copy up, the results' copy down)."""
    p = ctx.get("profile")
    if not p or _device_total(p) <= 0:
        return None
    return 100.0 * (p["by_cat"].get("gpu_memcpy", 0.0)
                    + p["by_cat"].get("gpu_memset", 0.0)) / _device_total(p)


#: the scheduler's spans inside a drain, in the order a batch runs them
PARTS = ("partition", "bucket", "residency", "dispatch", "device_sync",
         "collect")


def drain_parts(ctx) -> list[dict]:
    """Seconds of each drain of the window by part: the scheduler's
    spans inside it (:data:`PARTS`), the rest of the drain
    (``other``), and the client's time before it since the last drain
    ended (``client``: drawing the inputs, submitting, tallying the last
    drain's results)."""
    w = ctx.get("span_window")
    if not w or w[1] is None:
        return []
    spans = [s for s in ctx["spans"] if s.get("ph") == "X"
             and w[0] <= s["ts"] and s["ts"] + s["dur"] <= w[1]]
    drains = sorted((s for s in spans if s["name"] == "drain"),
                    key=lambda s: s["ts"])
    out, edge = [], w[0]
    for d in drains:
        end = d["ts"] + d["dur"]
        parts = dict.fromkeys(PARTS, 0.0)
        for s in spans:
            if s["name"] in parts and s["tid"] == d["tid"] \
                    and d["ts"] <= s["ts"] and s["ts"] + s["dur"] <= end:
                parts[s["name"]] += s["dur"] / 1e6
        parts["other"] = d["dur"] / 1e6 - sum(parts.values())
        parts["client"] = (d["ts"] - edge) / 1e6
        edge = end
        out.append(parts)
    return out
