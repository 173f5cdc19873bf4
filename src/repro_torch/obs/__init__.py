"""`repro_torch.obs` — deterministic observability for schedules, sweeps, serving.

Two strictly separated channels (docs/ARCHITECTURE.md §13):

* **sim-time** — `Tracer` spans/counters/histograms over a logical tick
  clock or explicit simulated-cycle intervals, the Chrome-trace exporter
  (`trace_schedule`, `serving_trace_events`), and the `bottleneck_report`.
  Pure functions of recorded state: byte-identical across runs, pinned to
  the ``deterministic`` staticcheck tier.
* **wall-time** — `repro_torch.obs.realtime.wall_tracer`, the only wall-clock
  entry point, pinned REALTIME and confined to operator-facing output.

    >>> from repro_torch.obs import Tracer
    >>> tr = Tracer()
    >>> with tr.span("sweep.point", point="k0"):
    ...     tr.count("sweep.computed")
    >>> tr.snapshot()["counters"]
    {'sweep.computed': 1.0}
"""
from repro_torch.obs.events import (Histogram, InMemorySink, JsonlSink,
                              MetricsRegistry, Sink, SpanEvent)
from repro_torch.obs.export import (chrome_trace, chrome_trace_json,
                              schedule_trace_events, serving_trace_events,
                              trace_schedule, validate_trace_events,
                              write_chrome_trace)
from repro_torch.obs.report import BottleneckReport, bottleneck_report
from repro_torch.obs.tracing import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "BottleneckReport",
    "Histogram",
    "InMemorySink",
    "JsonlSink",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "Sink",
    "SpanEvent",
    "Tracer",
    "bottleneck_report",
    "chrome_trace",
    "chrome_trace_json",
    "schedule_trace_events",
    "serving_trace_events",
    "trace_schedule",
    "validate_trace_events",
    "write_chrome_trace",
]
