"""Flight recorder: a bounded, always-on ring buffer of recent
span/event records, dumped as a Perfetto-compatible "blackbox" JSON
when something goes wrong.

The :mod:`repro_torch.obs.trace` tracer records *everything* and therefore
must be off in production.  The recorder inverts the trade: it records
only a fixed-size tail (a ``deque(maxlen=...)``, O(1) memory, one
append per record) and is meant to stay installed for the life of a
:class:`~repro.fleet.service.FleetService`.  When a watchdog reset,
retry exhaustion, or injected fault fires, ``dump()`` freezes the ring
into a Chrome/Perfetto trace-event file — so every production failure
ships with its last ~N events of context instead of a bare counter
increment.

Layering note: :mod:`repro_torch.obs.trace` imports this module so its
module-level ``span()`` / ``event()`` helpers can feed the recorder;
this module must therefore not import ``trace``.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import os
import tempfile
import threading
import time

__all__ = [
    "FlightRecorder",
    "current_recorder",
    "record",
    "trigger",
]

_PID = os.getpid()


def _jsonable(obj):
    """Best-effort JSON fallback for arbitrary span args (mirrors the
    tracer's serializer; kept local to avoid an import cycle)."""
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return repr(obj)


class FlightRecorder:
    """Bounded ring of recent events with rate-limited blackbox dumps.

    Parameters
    ----------
    capacity:
        Ring size in records; the memory bound.
    blackbox_dir:
        Where dumps land.  Created on first dump; defaults to a fresh
        ``repro-torch-blackbox-*`` temp directory.
    label:
        Embedded in dump filenames and metadata (e.g. a service name).
    min_dump_interval_s:
        Per-reason rate limit so a fault storm produces one dump per
        reason per interval instead of thousands.
    """

    def __init__(self, capacity=4096, blackbox_dir=None,
                 label="service", min_dump_interval_s=1.0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.label = label
        self.min_dump_interval_s = min_dump_interval_s
        self._blackbox_dir = blackbox_dir
        self._t0_ns = time.perf_counter_ns()
        self._buf = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tids = {}
        self._last_dump = {}
        self._seq = 0
        self.recorded = 0
        self.dumps = []

    # ------------------------------------------------------ recording
    def _now_us(self):
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    def _tid(self):
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids) + 1)
        return tid

    def record(self, name, cat="event", **args):
        """Append an instant event.  O(1); safe from any thread."""
        rec = {
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self._now_us(), "pid": _PID, "tid": self._tid(),
            "args": args,
        }
        with self._lock:
            self.recorded += 1
            self._buf.append(rec)

    def record_span(self, name, t0_ns, t1_ns, cat="span", args=None):
        """Append a completed span (called by the trace module when a
        ``span()`` context exits with a recorder installed)."""
        rec = {
            "name": name, "cat": cat, "ph": "X",
            "ts": (t0_ns - self._t0_ns) / 1e3,
            "dur": max(0.0, (t1_ns - t0_ns) / 1e3),
            "pid": _PID, "tid": self._tid(),
            "args": args or {},
        }
        with self._lock:
            self.recorded += 1
            self._buf.append(rec)

    # --------------------------------------------------------- reads
    def __len__(self):
        return len(self._buf)

    def tail(self, n=None):
        """The most recent ``n`` records (all, when ``n`` is None)."""
        with self._lock:
            recs = list(self._buf)
        return recs if n is None else recs[-n:]

    def recent_for(self, ticket, n=32):
        """Records relevant to one ticket: entries that mention its id
        plus id-less cohort context (dispatches, resets, faults)."""
        out = []
        for r in self.tail():
            args = r.get("args") or {}
            rid = args.get("id", args.get("ticket"))
            if rid is None or str(rid) == str(ticket):
                out.append(r)
        return out[-n:]

    # --------------------------------------------------------- dumps
    @property
    def blackbox_dir(self):
        if self._blackbox_dir is None:
            self._blackbox_dir = tempfile.mkdtemp(
                prefix="repro-torch-blackbox-")
        return self._blackbox_dir

    def to_chrome(self, reason=None, **info):
        """The ring as a Chrome/Perfetto trace-event document."""
        with self._lock:
            events = [dict(r) for r in self._buf]
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "tool": "repro_torch.obs.recorder",
                "label": self.label,
                "reason": reason,
                "capacity": self.capacity,
                "recorded": self.recorded,
                **info,
            },
        }

    def dump(self, reason, force=False, **info):
        """Freeze the ring to a blackbox JSON file; returns the path,
        or ``None`` when rate-limited."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if (not force and last is not None
                    and now - last < self.min_dump_interval_s):
                return None
            self._last_dump[reason] = now
            self._seq += 1
            seq = self._seq
        self.record("blackbox_dump", cat="recorder",
                    reason=reason, **info)
        doc = self.to_chrome(reason=reason, **info)
        path = os.path.join(
            self.blackbox_dir,
            f"blackbox-{self.label}-{seq:03d}-{reason}.json")
        with open(path, "w") as f:
            json.dump(doc, f, default=_jsonable)
        self.dumps.append(path)
        return path

    # -------------------------------------------------------- ambient
    @contextlib.contextmanager
    def installed(self):
        """Make this recorder ambient for the calling context.  The
        reset token is a closure local — overlapping installs across
        threads (watchdog-abandoned drains) cannot interleave."""
        tok = _RECORDER.set(self)
        try:
            yield self
        finally:
            _RECORDER.reset(tok)


# --------------------------------------------------------------------
# ambient recorder

_RECORDER: contextvars.ContextVar[FlightRecorder | None] = \
    contextvars.ContextVar("repro_torch_obs_recorder", default=None)


def current_recorder():
    """The ambient recorder, or ``None``."""
    return _RECORDER.get()


def record(name, cat="event", **args):
    """Record into the ambient recorder; one contextvar read and a
    no-op when none is installed."""
    rec = _RECORDER.get()
    if rec is not None:
        rec.record(name, cat=cat, **args)


def trigger(reason, **info):
    """Dump the ambient recorder's blackbox (rate-limited); returns
    the path or ``None``."""
    rec = _RECORDER.get()
    if rec is not None:
        return rec.dump(reason, **info)
    return None
