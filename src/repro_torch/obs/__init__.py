"""Observability for the port: the tracer and the flight recorder that
the executor and the fleet open spans through (copies of the
reference's framework-free ``repro.obs.trace`` and ``repro.obs.recorder``)."""
from .trace import NULL_SPAN, Tracer, current_tracer, event, span
from .recorder import FlightRecorder, current_recorder

__all__ = ["Tracer", "span", "event", "current_tracer", "NULL_SPAN",
           "FlightRecorder", "current_recorder"]
