"""Observability for the port: the tracer and the flight recorder that
the executor and the fleet open spans through, and the event counters
that the compiled tiers bake (copies of the reference's framework-free
``repro.obs.trace``, ``repro.obs.recorder`` and ``repro.obs.counters``)."""
from .trace import NULL_SPAN, Tracer, current_tracer, event, span
from .counters import EventCounters, aggregate
from .recorder import FlightRecorder, current_recorder

__all__ = ["Tracer", "span", "event", "current_tracer", "NULL_SPAN",
           "FlightRecorder", "current_recorder", "EventCounters", "aggregate"]
