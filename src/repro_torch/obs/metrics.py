"""Always-on serving metrics: a thread-safe registry of counters,
(a copy of the reference's framework-free ``repro.obs.metrics``).
gauges, and fixed-bucket histograms with label sets.

Unlike the :mod:`repro_torch.obs.trace` tracer — which is zero-overhead
precisely because it is *off* in production — the registry is designed
to stay installed for the life of a service.  Every primitive is a
dict update or a couple of list increments under one registry lock, so
the cost per operation is bounded and small (the ``benchmarks/obs.py``
gate holds the whole telemetry stack to <=3% of serve throughput), and
nothing here ever touches job *results*: bit-identity with telemetry
on/off is asserted in CI.

Three layers:

``MetricsRegistry``
    The mutable store.  ``counter`` / ``gauge`` / ``histogram`` create
    (or fetch) a named family with a fixed tuple of label names; the
    shorthand ``inc`` / ``set_gauge`` / ``observe`` auto-create
    families from the label keys at the call site.  Histograms carry a
    rolling window (time-sliced delta ring) alongside the lifetime
    buckets so p50/p99 can be read "over the last N seconds".

``MetricsSnapshot``
    An immutable copy of the registry at one instant.  Knows how to
    compute bucket-interpolated percentiles and SLO error-budget burn,
    round-trips through JSON, and renders the Prometheus text
    exposition format.

Ambient helpers
    ``installed()`` puts a registry in a contextvar;
    module-level ``inc`` / ``observe`` / ``set_gauge`` no-op in one
    contextvar read when nothing is installed.  This is how leaf code
    (``fleet/engine.py``, ``fleet/faults.py``) reports without
    threading a registry through every signature.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import threading
import time
from collections import deque

__all__ = [
    "MetricsRegistry",
    "MetricsSnapshot",
    "DEFAULT_TIME_BUCKETS",
    "SIZE_BUCKETS",
    "current_registry",
    "inc",
    "observe",
    "set_gauge",
]

# Log-spaced seconds ladder: 0.5 ms .. 10 s covers everything from a
# single compiled dispatch to a chaos-hang drain; the +Inf bucket is
# implicit.
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Powers of two for cohort / batch sizes.
SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)

_WINDOW_SLICES = 6


def _labelkey(labelnames, labels):
    try:
        return tuple(str(labels[k]) for k in labelnames)
    except KeyError as e:
        raise ValueError(
            f"missing label {e.args[0]!r}; expected {labelnames}") from e


class _ScalarChild:
    """One (labelvalues -> value) cell of a counter or gauge family."""

    __slots__ = ("_family", "value")

    def __init__(self, family):
        self._family = family
        self.value = 0.0

    def inc(self, value=1.0):
        if value < 0 and self._family.kind == "counter":
            raise ValueError("counters are monotonic; inc() needs >= 0")
        with self._family._lock:
            self.value += value

    def set(self, value):
        with self._family._lock:
            self.value = float(value)


class _HistChild:
    """One cell of a histogram family: lifetime per-bucket counts plus
    a rolling window kept as a ring of time-sliced deltas."""

    __slots__ = ("_family", "counts", "sum", "count",
                 "_slice", "_scounts", "_ssum", "_scount", "_ring")

    def __init__(self, family):
        self._family = family
        n = len(family.buckets) + 1          # last slot = +Inf
        self.counts = [0] * n
        self.sum = 0.0
        self.count = 0
        self._slice = None                   # current slice id
        self._scounts = [0] * n              # deltas within the slice
        self._ssum = 0.0
        self._scount = 0
        self._ring = deque()                 # (slice_id, counts, sum, n)

    def _bucket_index(self, value):
        buckets = self._family.buckets
        lo, hi = 0, len(buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def _roll(self, sid):
        """Close the current slice into the ring; evict stale slices."""
        if self._slice is not None and self._scount:
            self._ring.append(
                (self._slice, self._scounts, self._ssum, self._scount))
            self._scounts = [0] * (len(self._family.buckets) + 1)
            self._ssum = 0.0
            self._scount = 0
        self._slice = sid
        horizon = sid - _WINDOW_SLICES
        while self._ring and self._ring[0][0] <= horizon:
            self._ring.popleft()

    def observe(self, value):
        fam = self._family
        with fam._lock:
            i = self._bucket_index(value)
            self.counts[i] += 1
            self.sum += value
            self.count += 1
            if fam.window_s:
                sid = int(fam._clock() // fam._slice_s)
                if sid != self._slice:
                    self._roll(sid)
                self._scounts[i] += 1
                self._ssum += value
                self._scount += 1

    def _window_state(self):
        """(counts, sum, count) over the rolling window.  Caller holds
        the registry lock."""
        fam = self._family
        if not fam.window_s:
            return None
        sid = int(fam._clock() // fam._slice_s)
        if sid != self._slice:
            self._roll(sid)
        counts = list(self._scounts)
        total, n = self._ssum, self._scount
        for _, c, s, k in self._ring:
            for j, v in enumerate(c):
                counts[j] += v
            total += s
            n += k
        return counts, total, n


class _Family:
    """A named metric with a fixed label-name tuple and one child per
    observed label-value combination."""

    __slots__ = ("name", "kind", "help", "labelnames", "buckets",
                 "window_s", "_slice_s", "_clock", "_lock", "_children")

    def __init__(self, name, kind, help_text, labelnames, lock, clock,
                 buckets=None, window_s=None):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets else None
        self.window_s = window_s
        self._slice_s = (window_s / _WINDOW_SLICES) if window_s else None
        self._clock = clock
        self._lock = lock
        self._children = {}

    def labels(self, **labels):
        key = _labelkey(self.labelnames, labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = (_HistChild(self)
                             if self.kind == "histogram"
                             else _ScalarChild(self))
                    self._children[key] = child
        return child

    # convenience when the family is label-free or the caller has the
    # labels inline
    def inc(self, value=1.0, **labels):
        self.labels(**labels).inc(value)

    def set(self, value, **labels):
        self.labels(**labels).set(value)

    def observe(self, value, **labels):
        self.labels(**labels).observe(value)

    def value(self, **labels):
        key = _labelkey(self.labelnames, labels)
        child = self._children.get(key)
        return child.value if child is not None else 0.0

    def total(self, **label_filter):
        """Sum child values whose labels match every given filter."""
        idx = [(self.labelnames.index(k), str(v))
               for k, v in label_filter.items()]
        out = 0.0
        with self._lock:
            for key, child in self._children.items():
                if all(key[i] == v for i, v in idx):
                    out += child.value
        return out


class MetricsRegistry:
    """Thread-safe store of metric families.

    One lock guards every mutation; all primitives are O(1) dict/list
    work so the lock is held for sub-microsecond stretches.  A single
    registry is intended to outlive scheduler replacements (the
    reference's ``FleetService`` watchdog hands the same
    registry to each replacement scheduler), which is what makes
    service-lifetime counts drift-free.
    """

    def __init__(self, clock=time.monotonic):
        self._lock = threading.RLock()
        self._clock = clock
        self._families = {}

    # ------------------------------------------------------- creation
    def _family(self, name, kind, help_text, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, not {kind}")
                if tuple(labelnames) != fam.labelnames:
                    raise ValueError(
                        f"metric {name!r} labelnames {fam.labelnames} "
                        f"!= {tuple(labelnames)}")
                return fam
            fam = _Family(name, kind, help_text, labelnames,
                          self._lock, self._clock, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, help_text="", labelnames=()):
        return self._family(name, "counter", help_text, labelnames)

    def gauge(self, name, help_text="", labelnames=()):
        return self._family(name, "gauge", help_text, labelnames)

    def histogram(self, name, help_text="", labelnames=(),
                  buckets=DEFAULT_TIME_BUCKETS, window_s=None):
        return self._family(name, "histogram", help_text, labelnames,
                            buckets=buckets, window_s=window_s)

    # ------------------------------------------- call-site shorthands
    def inc(self, name, value=1.0, **labels):
        fam = self._families.get(name)
        if fam is None:
            fam = self.counter(name, labelnames=tuple(sorted(labels)))
        fam.labels(**labels).inc(value)

    def set_gauge(self, name, value, **labels):
        fam = self._families.get(name)
        if fam is None:
            fam = self.gauge(name, labelnames=tuple(sorted(labels)))
        fam.labels(**labels).set(value)

    def observe(self, name, value, **labels):
        fam = self._families.get(name)
        if fam is None:
            fam = self.histogram(name, labelnames=tuple(sorted(labels)))
        fam.labels(**labels).observe(value)

    # ---------------------------------------------------------- reads
    def value(self, name, **labels):
        fam = self._families.get(name)
        return fam.value(**labels) if fam is not None else 0.0

    def total(self, name, **label_filter):
        fam = self._families.get(name)
        return fam.total(**label_filter) if fam is not None else 0.0

    def snapshot(self):
        """An immutable :class:`MetricsSnapshot` of everything."""
        out = []
        with self._lock:
            for fam in self._families.values():
                samples = []
                for key, child in sorted(fam._children.items()):
                    labels = dict(zip(fam.labelnames, key))
                    if fam.kind == "histogram":
                        win = child._window_state()
                        sample = {
                            "labels": labels,
                            "counts": list(child.counts),
                            "sum": child.sum,
                            "count": child.count,
                        }
                        if win is not None:
                            wc, ws, wn = win
                            sample["window"] = {
                                "counts": wc, "sum": ws, "count": wn,
                                "span_s": fam.window_s,
                            }
                    else:
                        sample = {"labels": labels, "value": child.value}
                    samples.append(sample)
                out.append({
                    "name": fam.name,
                    "type": fam.kind,
                    "help": fam.help,
                    "labelnames": list(fam.labelnames),
                    "buckets": (list(fam.buckets)
                                if fam.buckets else None),
                    "samples": samples,
                })
        return MetricsSnapshot(ts=time.time(), metrics=out)

    def to_prometheus(self):
        return self.snapshot().to_prometheus()

    # -------------------------------------------------------- ambient
    @contextlib.contextmanager
    def installed(self):
        """Make this registry the ambient one for the calling context.

        The reset token lives in a closure local, so overlapping
        installs from different threads (a watchdog-abandoned drain
        thread racing its replacement) cannot interleave.
        """
        tok = _REGISTRY.set(self)
        try:
            yield self
        finally:
            _REGISTRY.reset(tok)


# --------------------------------------------------------------------
# snapshot


def _fmt(v):
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.10g}"


def _prom_labels(labels):
    if not labels:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + body + "}"


@dataclasses.dataclass
class MetricsSnapshot:
    """A frozen copy of a registry: the unit of export, reporting, and
    SLO math.  ``meta`` carries side-band context (e.g. the service's
    computed SLO status at close)."""

    ts: float
    metrics: list
    meta: dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------- lookups
    def _metric(self, name):
        for m in self.metrics:
            if m["name"] == name:
                return m
        return None

    def value(self, name, **labels):
        m = self._metric(name)
        if m is None:
            return 0.0
        want = {k: str(v) for k, v in labels.items()}
        for s in m["samples"]:
            if s["labels"] == want:
                return s.get("value", s.get("count", 0.0))
        return 0.0

    def total(self, name, **label_filter):
        m = self._metric(name)
        if m is None:
            return 0.0
        want = {k: str(v) for k, v in label_filter.items()}
        out = 0.0
        for s in m["samples"]:
            if all(s["labels"].get(k) == v for k, v in want.items()):
                out += s.get("value", s.get("count", 0.0))
        return out

    def _merged_hist(self, name, window=False, **label_filter):
        """Merge matching histogram children into one (buckets,
        counts, sum, count) tuple — percentiles across label values."""
        m = self._metric(name)
        if m is None or m["type"] != "histogram":
            return None
        buckets = m["buckets"]
        counts = [0] * (len(buckets) + 1)
        total, n = 0.0, 0
        want = {k: str(v) for k, v in label_filter.items()}
        for s in m["samples"]:
            if not all(s["labels"].get(k) == v for k, v in want.items()):
                continue
            src = s.get("window") if window else s
            if src is None:
                src = s
            for j, c in enumerate(src["counts"]):
                counts[j] += c
            total += src["sum"]
            n += src["count"]
        return buckets, counts, total, n

    def percentile(self, name, q, window=False, **label_filter):
        """Bucket-interpolated q-quantile (q in [0, 1]); ``None`` when
        the (windowed) histogram is empty."""
        merged = self._merged_hist(name, window=window, **label_filter)
        if merged is None:
            return None
        buckets, counts, _, n = merged
        if n == 0:
            return None
        rank = q * n
        cum = 0
        for i, c in enumerate(counts):
            prev = cum
            cum += c
            if cum >= rank and c:
                lo = buckets[i - 1] if i > 0 else 0.0
                hi = buckets[i] if i < len(buckets) else buckets[-1]
                if i >= len(buckets):
                    return hi            # +Inf bucket: clamp
                return lo + (hi - lo) * (rank - prev) / c
        return buckets[-1]

    def count_le(self, name, threshold, window=False, **label_filter):
        """Observations <= threshold, rounded up to the nearest bucket
        edge (conservative for SLO "good" counts)."""
        merged = self._merged_hist(name, window=window, **label_filter)
        if merged is None:
            return 0
        buckets, counts, _, _ = merged
        good = 0
        for i, edge in enumerate(buckets):
            if edge > threshold:
                break
            good += counts[i]
        return good

    def hist_count(self, name, window=False, **label_filter):
        merged = self._merged_hist(name, window=window, **label_filter)
        return merged[3] if merged else 0

    def slo_burn(self, name, threshold_s, target, window=True,
                 good_filter=None, **label_filter):
        """Error-budget burn rate: fraction of bad requests divided by
        the budget (1 - target).  1.0 = burning exactly at budget.

        ``good_filter`` narrows which label values count as *good*
        (e.g. ``{"outcome": "ok"}``) while the denominator spans every
        child matching ``label_filter`` — so failed requests are bad no
        matter how fast they failed.
        """
        total = self.hist_count(name, window=window, **label_filter)
        if total == 0:
            return 0.0
        gf = dict(label_filter)
        gf.update(good_filter or {})
        good = self.count_le(name, threshold_s, window=window, **gf)
        bad_frac = max(0.0, 1.0 - good / total)
        budget = max(1e-9, 1.0 - target)
        return bad_frac / budget

    # -------------------------------------------------------- export
    def to_prometheus(self):
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        for m in self.metrics:
            name, kind = m["name"], m["type"]
            if m["help"]:
                lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} {kind}")
            for s in m["samples"]:
                labels = s["labels"]
                if kind == "histogram":
                    cum = 0
                    for i, edge in enumerate(m["buckets"]):
                        cum += s["counts"][i]
                        lab = dict(labels, le=_fmt(edge))
                        lines.append(
                            f"{name}_bucket{_prom_labels(lab)} {cum}")
                    cum += s["counts"][-1]
                    lab = dict(labels, le="+Inf")
                    lines.append(
                        f"{name}_bucket{_prom_labels(lab)} {cum}")
                    lines.append(
                        f"{name}_sum{_prom_labels(labels)} "
                        f"{_fmt(s['sum'])}")
                    lines.append(
                        f"{name}_count{_prom_labels(labels)} "
                        f"{s['count']}")
                else:
                    lines.append(
                        f"{name}{_prom_labels(labels)} "
                        f"{_fmt(s['value'])}")
        return "\n".join(lines) + "\n"

    def to_json(self):
        # the format's name is the reference's: either package reads
        # the other's snapshots
        return {"kind": "repro.obs.metrics", "version": 1,
                "ts": self.ts, "meta": self.meta,
                "metrics": self.metrics}

    @classmethod
    def from_json(cls, doc):
        if doc.get("kind") != "repro.obs.metrics":
            raise ValueError("not a repro.obs.metrics snapshot")
        return cls(ts=doc["ts"], metrics=doc["metrics"],
                   meta=doc.get("meta", {}))

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        return path

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls.from_json(json.load(f))


# --------------------------------------------------------------------
# ambient registry

_REGISTRY: contextvars.ContextVar[MetricsRegistry | None] = \
    contextvars.ContextVar("repro_torch_obs_metrics", default=None)


def current_registry():
    """The ambient registry, or ``None``."""
    return _REGISTRY.get()


def inc(name, value=1.0, **labels):
    reg = _REGISTRY.get()
    if reg is not None:
        reg.inc(name, value, **labels)


def observe(name, value, **labels):
    reg = _REGISTRY.get()
    if reg is not None:
        reg.observe(name, value, **labels)


def set_gauge(name, value, **labels):
    reg = _REGISTRY.get()
    if reg is not None:
        reg.set_gauge(name, value, **labels)
