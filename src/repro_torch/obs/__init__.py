"""Observability (port of repro.obs): the metrics registry,
per-query trace spans with the maintenance event log, the workload flight
recorder, and the HTTP exposition endpoint.

  * `metrics` -- counters, gauges and histograms in one process registry;
    the pager, executor, front door and scheduler register under labeled
    scopes, so `MicroNN.stats()` is a derived view of one source of truth.
  * `trace` -- the stage hook (`stage`: a span of the thread's active
    trace, a profiler range while one collects), per-query spans
    (`QueryTrace`), the bounded `TraceRing` of recent traces and
    maintenance events, the slow-query log.
  * `recorder` -- bounded, sampled on-disk capture of (ts_offset, tenant,
    spec, vectors) and `replay()`, which checks bit-identical ResultSets.
  * `http` -- a stdlib HTTP daemon thread serving /metrics, /healthz,
    /traces, /slow, /events.
"""
from . import http, metrics, recorder, trace
from .http import ExpositionServer
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, Scope,
                      default_registry, next_instance)
from .recorder import FlightRecorder, ReplayReport, recording, replay
from .trace import (MaintEvent, QueryTrace, Span, TraceRing, activate,
                    current, enabled, set_enabled, stage)

__all__ = [
    "metrics", "trace", "recorder", "http",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Scope",
    "default_registry", "next_instance",
    "MaintEvent", "QueryTrace", "Span", "TraceRing",
    "activate", "current", "enabled", "set_enabled", "stage",
    "FlightRecorder", "ReplayReport", "recording", "replay",
    "ExpositionServer",
]
