"""Contextvar-scoped tracing with a Chrome/Perfetto trace-event exporter.

The soft-GPU stack's observability layer: nested wall-clock **spans**
(``drain -> partition -> compile -> residency -> dispatch ->
device_sync -> collect``), point-in-time **instant events** (tier
decisions, per-drain counter rollups) and **async pairs** (per-job
submit -> deliver latency), all recorded against one monotonic clock
and exported as Chrome trace-event JSON — load the file at
``ui.perfetto.dev`` or ``chrome://tracing``.

Zero overhead when disabled is the design contract: every
instrumentation site goes through :func:`span` / :func:`event` /
:func:`current_tracer`, which cost one contextvar read and a ``None``
check when no tracer is installed (``span`` returns a shared no-op
singleton; no timestamps are taken, nothing allocates per event).
Results are bit-identical with tracing on or off — the tracer observes
the host-side orchestration, never the computation.

    tracer = Tracer()
    with tracer:                        # installs into the contextvar
        fleet.drain()
    tracer.save("trace.json")

Instrumented code does not import the tracer instance; it calls the
module-level helpers::

    with span("dispatch", cores=n):
        ...
    event("tier_decision", tier=tier, rule=rule)
"""
from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import Any

from . import recorder as _recorder

__all__ = [
    "Tracer", "span", "event", "current_tracer", "NULL_SPAN",
]

_TRACER: contextvars.ContextVar["Tracer | None"] = \
    contextvars.ContextVar("repro_torch_obs_tracer", default=None)


def current_tracer() -> "Tracer | None":
    """The tracer installed in the current context, or ``None``."""
    return _TRACER.get()


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""

    __slots__ = ()
    #: instrumentation sites can skip building expensive span arguments
    #: (digests, feature dicts) when the span is inert
    active = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records ``[enter, exit)`` as a complete event in
    the tracer and/or the flight recorder (whichever are installed)."""

    __slots__ = ("_tr", "_rec", "_name", "_args", "_t0")
    active = True

    def __init__(self, tr: "Tracer | None", name: str, args: dict,
                 rec=None):
        self._tr = tr
        self._rec = rec
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self._tr
        if tr is not None:
            tr._events.append({
                "name": self._name, "cat": "span", "ph": "X",
                "ts": (self._t0 - tr._t0) / 1e3,
                "dur": (t1 - self._t0) / 1e3,
                "pid": tr._pid, "tid": tr._tid(),
                "args": self._args,
            })
        if self._rec is not None:
            self._rec.record_span(self._name, self._t0, t1,
                                  args=self._args)
        return False

    def set(self, **args):
        """Attach/overwrite span arguments (shown in the trace viewer)."""
        self._args.update(args)
        return self


class Tracer:
    """An event sink plus the context-manager that installs it.

    All timestamps are microseconds relative to the tracer's creation,
    from ``time.perf_counter_ns`` (monotonic).  ``with tracer:`` scopes
    activation; activation nests and is per-context (contextvar), so a
    tracer can be installed around any slice of work without touching
    global state.
    """

    def __init__(self, label: str = "repro_torch"):
        self.label = label
        self._t0 = time.perf_counter_ns()
        self._pid = os.getpid()
        self._events: list[dict] = []
        self._tids: dict[int, int] = {}
        self.counters: dict[str, int] = {}
        # per-thread token stacks: contextvar reset tokens are only
        # valid in the context that set them, and one tracer may be
        # entered concurrently from many dispatcher threads
        self._tokens = threading.local()

    # ------------------------------------------------------ activation
    def __enter__(self):
        stack = getattr(self._tokens, "stack", None)
        if stack is None:
            stack = self._tokens.stack = []
        stack.append(_TRACER.set(self))
        return self

    def __exit__(self, *exc):
        _TRACER.reset(self._tokens.stack.pop())
        return False

    # --------------------------------------------------------- recording
    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    def now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def event(self, name: str, cat: str = "event", **args) -> None:
        """Record an instant event (a point on the timeline).  ``cat``
        groups events for filtering in the Perfetto UI and in
        the reference's :mod:`repro.obs.report` (e.g. ``"serve"`` for retry/timeout/
        degrade events, ``"fault"`` for injections)."""
        self._events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self.now_us(), "pid": self._pid, "tid": self._tid(),
            "args": args,
        })

    def async_begin(self, name: str, id: int, **args) -> None:
        """Open one side of an async pair (e.g. job submit)."""
        self._events.append({
            "name": name, "cat": "async", "ph": "b", "id": int(id),
            "ts": self.now_us(), "pid": self._pid, "tid": self._tid(),
            "args": args,
        })

    def async_end(self, name: str, id: int, **args) -> None:
        """Close an async pair (e.g. job result delivered)."""
        self._events.append({
            "name": name, "cat": "async", "ph": "e", "id": int(id),
            "ts": self.now_us(), "pid": self._pid, "tid": self._tid(),
            "args": args,
        })

    def add_counters(self, counters: dict[str, int]) -> None:
        """Accumulate event-counter totals across the trace's lifetime."""
        for k, v in counters.items():
            self.counters[k] = self.counters.get(k, 0) + int(v)

    @property
    def events(self) -> list[dict]:
        return self._events

    # ----------------------------------------------------------- export
    def to_chrome(self) -> dict:
        """The trace as a Chrome trace-event JSON object."""
        evs = [{
            "name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
            "args": {"name": f"repro_torch.obs:{self.label}"},
        }]
        evs.extend(self._events)
        if self.counters:
            evs.append({
                "name": "counters_total", "cat": "event", "ph": "i",
                "s": "g", "ts": self.now_us(), "pid": self._pid,
                "tid": 0, "args": {"counters": dict(self.counters)},
            })
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"tool": "repro_torch.obs", "label": self.label}}

    def save(self, path: str) -> None:
        """Write Chrome/Perfetto-loadable trace JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, default=_jsonable)


def _jsonable(x: Any):
    """Fallback serializer: numpy scalars/arrays -> Python numbers/lists."""
    if hasattr(x, "item") and getattr(x, "ndim", None) in (0, None):
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    return str(x)


def span(name: str, **args):
    """A span against the current tracer and/or flight recorder; a
    shared no-op when neither is installed.

    The disabled path is two contextvar reads and ``None`` checks —
    callers building expensive span arguments should gate on
    ``sp.active`` (or :func:`current_tracer`) instead of precomputing.
    """
    tr = _TRACER.get()
    rec = _recorder.current_recorder()
    if tr is None and rec is None:
        return NULL_SPAN
    return _Span(tr, name, args, rec=rec)


def event(name: str, cat: str = "event", **args) -> None:
    """An instant event against the current tracer and/or flight
    recorder; no-op when neither is installed."""
    tr = _TRACER.get()
    if tr is not None:
        tr.event(name, cat=cat, **args)
    rec = _recorder.current_recorder()
    if rec is not None:
        rec.record(name, cat=cat, **args)
