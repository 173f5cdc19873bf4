"""Sim-time observability primitives: span events, histograms, sinks.

Everything in this module lives on the *sim-time* channel of the repo's
two-channel observability design (docs/ARCHITECTURE.md §13): timestamps
are logical ticks or simulated cycles — pure functions of schedule or
serving state — never the wall clock, so recorded events and metric
snapshots are byte-identical across runs and safe for the
``deterministic`` staticcheck tier.  The only wall-time entry point of
the package is `repro_torch.obs.realtime`, which is pinned to the REALTIME
tier and never feeds content-keyed records.

    >>> sink = InMemorySink()
    >>> sink.emit(SpanEvent(name="ga.generation", t0=0.0, t1=1.0, depth=0,
    ...                     attrs={"evaluations": 12}))
    >>> sink.events[0].duration
    1.0
"""
from __future__ import annotations

import dataclasses
import json
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One closed span: a named [t0, t1] interval with nesting depth.

    The time unit is whatever clock the recording `Tracer` runs on —
    logical ticks by default, simulated cycles when the caller passes
    explicit times, wall seconds only under `repro_torch.obs.realtime`.

        >>> ev = SpanEvent("schedule", 0.0, 128.0, 0, {"cns": 64})
        >>> ev.duration, ev.to_dict()["name"]
        (128.0, 'schedule')
    """

    name: str
    t0: float
    t1: float
    depth: int
    attrs: Mapping = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "depth": self.depth, "attrs": dict(self.attrs)}


class Histogram:
    """Streaming summary of observed values: count/total/min/max.

    Deliberately bucket-free — a fixed summary is deterministic under any
    observation order that visits the same multiset of values, and cheap
    enough for the scheduling hot path.

        >>> h = Histogram()
        >>> for v in (4.0, 1.0, 7.0):
        ...     h.observe(v)
        >>> h.count, h.total, h.vmin, h.vmax
        (3, 12.0, 1.0, 7.0)
        >>> h.summary()["mean"]
        4.0
    """

    __slots__ = ("count", "total", "vmin", "vmax")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0, "total": 0.0, "mean": 0.0,
                    "min": 0.0, "max": 0.0}
        return {"count": self.count, "total": self.total,
                "mean": self.total / self.count,
                "min": self.vmin, "max": self.vmax}


class MetricsRegistry:
    """Named counters + histograms with a sorted, JSON-ready snapshot.

        >>> m = MetricsRegistry()
        >>> m.count("sweep.computed"); m.count("sweep.computed", 2)
        >>> m.observe("latency_cc", 128.0)
        >>> snap = m.snapshot()
        >>> snap["counters"], snap["histograms"]["latency_cc"]["count"]
        ({'sweep.computed': 3.0}, 1)
    """

    __slots__ = ("counters", "histograms")

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + float(n)

    def observe(self, name: str, value: float) -> None:
        hist = self.histograms.get(name)
        if hist is None:
            hist = self.histograms[name] = Histogram()
        hist.observe(value)

    def snapshot(self) -> dict:
        return {
            "counters": {k: self.counters[k] for k in sorted(self.counters)},
            "histograms": {k: self.histograms[k].summary()
                           for k in sorted(self.histograms)},
        }


class Sink:
    """Span-event consumer protocol: `emit(event)` per closed span.

        >>> class Count(Sink):
        ...     n = 0
        ...     def emit(self, event): self.n += 1
        >>> s = Count(); s.emit(SpanEvent("x", 0.0, 1.0, 0)); s.n
        1
    """

    def emit(self, event: SpanEvent) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Release any resources (no-op by default)."""


class InMemorySink(Sink):
    """Keeps every emitted span in order — the default `Tracer` sink.

        >>> s = InMemorySink()
        >>> s.emit(SpanEvent("a", 0.0, 2.0, 0))
        >>> [e.name for e in s.events]
        ['a']
    """

    def __init__(self):
        self.events: list[SpanEvent] = []

    def emit(self, event: SpanEvent) -> None:
        self.events.append(event)


class JsonlSink(Sink):
    """Appends each span as one sorted-key JSON line to a file.

    Lines are written with ``sort_keys=True``, so a file produced from a
    sim-time tracer is byte-identical across runs.

        >>> import os, tempfile
        >>> path = os.path.join(tempfile.mkdtemp(), "spans.jsonl")
        >>> s = JsonlSink(path)
        >>> s.emit(SpanEvent("a", 0.0, 2.0, 0, {"k": 1}))
        >>> s.close()
        >>> open(path).read()
        '{"attrs": {"k": 1}, "depth": 0, "name": "a", "t0": 0.0, "t1": 2.0}\\n'
    """

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a")

    def emit(self, event: SpanEvent) -> None:
        self._fh.write(json.dumps(event.to_dict(), sort_keys=True) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
