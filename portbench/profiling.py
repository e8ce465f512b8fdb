"""One profiled slice of a window, read from ``torch.profiler``'s trace.

The slice is marked by a ``record_function`` annotation, so its bounds,
the device's kernels and copies and the host's own clock line up: the
device is busy where a kernel, copy or fill runs, idle elsewhere, and
each idle gap is named by the innermost span of the program's tracer
that was open on the host at its middle.
"""
from __future__ import annotations

import bisect
import json
import os
import pathlib
import re
import time

MARK = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the port's hand-written eGPU kernels, by their CUDA function names
HAND_KERNELS = {"fp_step_kernel": "wavefront_alu",
                "wavefront_alu_kernel": "wavefront_alu",
                "ext_step_kernel": "dot_product",
                "dot_product_kernel": "dot_product"}
PAUSE_S = 0.05


def short_name(name: str) -> str:
    """A kernel's function name without its return type, namespaces,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            if ch == "(" and depth == 0:
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).split("::")[-1].strip()[:120] or name[:120]


def hand_kernel(name: str) -> str | None:
    """The hand kernel a device op belongs to, or ``None``."""
    base = short_name(name)
    return HAND_KERNELS.get(base)


class Slice:
    """Profile what runs between :meth:`start` and :meth:`stop`, on the
    thread that calls both.  ``tracer`` is the program's tracer (its
    spans name the idle gaps), or ``None``."""

    def __init__(self, out_dir: pathlib.Path, tracer=None):
        self.out_dir = out_dir
        self.tracer = tracer
        self.result: dict | None = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, so the first slice does not
        pay its start-up."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
        self.mark = torch.profiler.record_function(MARK)
        self.mark.__enter__()
        self.host_us0 = self.tracer.now_us() if self.tracer else 0.0

    def stop(self) -> None:
        """End the slice; :meth:`read` reads it, which takes the host a
        while, so a driver reads it once its window has closed."""
        import torch
        torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        time.sleep(PAUSE_S)
        self.prof.__exit__(None, None, None)

    def read(self) -> dict:
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"profile-{os.getpid()}.json"
        try:
            self.prof.export_chrome_trace(str(path))
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            path.unlink(missing_ok=True)
        self.prof = None
        self.result = read(events, self.host_us0,
                           self.tracer.events if self.tracer else [])
        return self.result


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans: list, t0: float, t1: float):
    """``label_at(t)``: the name of the shortest span open at host time
    ``t`` (microseconds of the tracer's clock), among the spans that
    overlap ``[t0, t1]``."""
    host = [(float(s["ts"]), float(s["ts"]) + float(s["dur"]), s["name"])
            for s in spans if s.get("ph") == "X"
            and float(s["ts"]) <= t1 and float(s["ts"]) + float(s["dur"])
            >= t0]
    cuts = sorted({x for a, b, _ in host for x in (a, b)})
    names = []
    for lo, hi in zip(cuts, cuts[1:]):
        mid = (lo + hi) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        names.append(min(inner, key=lambda h: h[1] - h[0])[2] if inner
                     else None)

    def label_at(t: float) -> str:
        i = bisect.bisect_right(cuts, t) - 1
        name = names[i] if 0 <= i < len(names) else None
        return name or "outside the program's spans"
    return label_at


def read(events: list, host_us0: float, spans: list) -> dict:
    """The slice's numbers from a Chrome trace's events (microseconds):
    ``window_s``, ``busy_s``, ``ops`` (device seconds and count by short
    name), ``hand`` (by hand kernel), ``by_cat`` (device seconds by the
    trace's category: ``kernel``, ``gpu_memcpy``, ``gpu_memset``),
    ``gaps`` (idle seconds by the host's span) and ``n_device``."""
    marks = [e for e in events if e.get("name") == MARK
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the profile holds no window mark")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev = []
    ops: dict = {}
    hand: dict = {}
    by_cat: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
        if b <= a:
            continue
        dev.append((a, b))
        by_cat[e["cat"]] = by_cat.get(e["cat"], 0.0) + (b - a) / 1e6
        name = short_name(e["name"])
        s, n = ops.get(name, (0.0, 0))
        ops[name] = (s + (b - a) / 1e6, n + 1)
        h = hand_kernel(e["name"])
        if h is not None:
            s, n = hand.get(h, (0.0, 0))
            hand[h] = (s + (b - a) / 1e6, n + 1)
    busy = _union(dev)
    label_at = _innermost(spans, host_us0, host_us0 + (w1 - w0))
    gaps: dict = {}
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            label = label_at(host_us0 + (edge + a) / 2 - w0)
            gaps[label] = gaps.get(label, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "ops": ops, "hand": hand, "by_cat": by_cat, "gaps": gaps,
            "n_device": len(dev)}


def breakdown(result: dict) -> dict:
    """The ten device ops that took most time, and the ten hosts' spans
    under which the device sat idle longest."""
    ops = sorted(((k, v[0]) for k, v in result["ops"].items()),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(result["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
