"""Observability for the port: the tracer and the flight recorder that
the executor and the fleet open spans through, the event counters that
the compiled tiers bake, the always-on metrics registry the scheduler
reports into, and the offline report (copies of the reference's
framework-free ``repro.obs`` modules).

``python -m repro_torch.obs.report trace.json`` summarizes traces and
blackbox dumps; ``python -m repro_torch.obs.report --metrics snap.json``
renders a metrics snapshot.
"""
from .trace import NULL_SPAN, Tracer, current_tracer, event, span
from .counters import EventCounters, aggregate
from .metrics import (
    DEFAULT_TIME_BUCKETS,
    MetricsRegistry,
    MetricsSnapshot,
    current_registry,
)
from .recorder import FlightRecorder, current_recorder

__all__ = [
    "Tracer", "span", "event", "current_tracer", "NULL_SPAN",
    "EventCounters", "aggregate",
    "MetricsRegistry", "MetricsSnapshot", "DEFAULT_TIME_BUCKETS",
    "current_registry",
    "FlightRecorder", "current_recorder",
]
