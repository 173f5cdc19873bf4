"""The `Tracer`: nested spans, counters, and histograms over any clock.

A tracer binds a clock to a `MetricsRegistry` and a span `Sink`.  The
default clock is a *logical tick counter* — each clock read returns the
next integer — so code instrumented on the sim-time channel (GA
generations, sweep points, engine schedules) records byte-identical
traces on every run.  Callers that already know their interval in
simulated cycles record it with `add_span(name, t0, t1)`; only
`repro_torch.obs.realtime.wall_tracer` ever installs a wall clock, and that
module is pinned to the REALTIME staticcheck tier.

Disabled tracing is free: instrumented call sites hold a tracer
attribute that defaults to None and guard every use with
``if tracer is not None`` (one predictable branch), or use the shared
`NULL_TRACER` whose methods are no-ops.  Either way the instrumented
code's outputs are bit-identical with tracing on, off, or absent — the
tracer observes, it never steers.

    >>> tr = Tracer()
    >>> with tr.span("ga.generation", gen=0):
    ...     tr.count("evaluations", 12)
    ...     tr.observe("best_edp", 4.0)
    >>> ev = tr.events[0]
    >>> (ev.name, ev.depth, ev.t1 - ev.t0)
    ('ga.generation', 0, 1.0)
    >>> tr.snapshot()["counters"]
    {'evaluations': 12.0}
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable

from repro_torch.obs.events import InMemorySink, MetricsRegistry, Sink, SpanEvent


class Tracer:
    """Span/counter/histogram recorder over a pluggable clock and sink.

    `clock=None` (the default) installs the logical tick counter; pass a
    callable returning floats to trace another time base.  `sink=None`
    installs an `InMemorySink`, exposed through `events`.

        >>> tr = Tracer()
        >>> with tr.span("outer"):
        ...     with tr.span("inner"):
        ...         pass
        >>> [(e.name, e.depth) for e in tr.events]
        [('inner', 1), ('outer', 0)]
        >>> tr.add_span("schedule", 0.0, 128.0, cns=64)
        >>> tr.events[-1].attrs["cns"]
        64
    """

    def __init__(self, sink: Sink | None = None,
                 clock: Callable[[], float] | None = None):
        self.sink = InMemorySink() if sink is None else sink
        self._clock = clock
        self._tick = 0
        self._depth = 0
        self.metrics = MetricsRegistry()

    # ---- clock -----------------------------------------------------------
    def now(self) -> float:
        """Current clock value (logical ticks unless a clock was given).

            >>> tr = Tracer()
            >>> tr.now(), tr.now()
            (0.0, 1.0)
        """
        if self._clock is not None:
            return self._clock()
        t = self._tick
        self._tick += 1
        return float(t)

    # ---- spans -----------------------------------------------------------
    @contextmanager
    def span(self, name: str, **attrs):
        """Context manager recording one nested span (closed on exit —
        exits by exception included, so traces never hold open spans).

            >>> tr = Tracer()
            >>> with tr.span("step", point="k0"):
            ...     pass
            >>> tr.events[0].attrs
            {'point': 'k0'}
        """
        t0 = self.now()
        depth = self._depth
        self._depth = depth + 1
        try:
            yield self
        finally:
            self._depth = depth
            self.sink.emit(SpanEvent(name=name, t0=t0, t1=self.now(),
                                     depth=depth, attrs=attrs))

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Record an already-timed interval (e.g. simulated cycles)."""
        self.sink.emit(SpanEvent(name=name, t0=float(t0), t1=float(t1),
                                 depth=self._depth, attrs=attrs))

    # ---- metrics ---------------------------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        self.metrics.count(name, n)

    def observe(self, name: str, value: float) -> None:
        self.metrics.observe(name, value)

    def snapshot(self) -> dict:
        """Sorted counters + histogram summaries (JSON-ready)."""
        return self.metrics.snapshot()

    # ---- introspection ---------------------------------------------------
    @property
    def events(self) -> list[SpanEvent]:
        """Recorded spans when the sink is in-memory (else empty)."""
        return getattr(self.sink, "events", [])

    def close(self) -> None:
        self.sink.close()


class NullTracer:
    """No-op tracer: every method returns immediately; `span` is a shared
    reusable no-op context manager.  Use the module-level `NULL_TRACER`
    instead of constructing one.

        >>> with NULL_TRACER.span("x"):
        ...     NULL_TRACER.count("n")
        >>> NULL_TRACER.snapshot()
        {'counters': {}, 'histograms': {}}
    """

    class _NoopSpan:
        __slots__ = ()

        def __enter__(self):
            return None

        def __exit__(self, *exc):
            return False

    _SPAN = _NoopSpan()

    def span(self, name: str, **attrs):
        return self._SPAN

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        pass

    def count(self, name: str, n: float = 1) -> None:
        pass

    def observe(self, name: str, value: float) -> None:
        pass

    def snapshot(self) -> dict:
        return {"counters": {}, "histograms": {}}

    def now(self) -> float:
        return 0.0

    @property
    def events(self) -> list:
        return []

    def close(self) -> None:
        pass


NULL_TRACER = NullTracer()
