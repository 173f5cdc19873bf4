"""Wall-time observability sink — the REALTIME half of the two-channel split,
and the device channel that rides on the profiler's clock.

This is the only module of `repro_torch.obs` allowed to read the wall clock
(it is pinned REALTIME in `repro_torch.analysis.staticcheck.tiers`, so the
linter's wall-clock rule does not apply here).  Wall-time spans wrap
*real execution* — worker wall time, store I/O, pool dispatch — and are
strictly for operator eyes: nothing recorded through a wall tracer may
reach content-keyed records or golden traces.
Everything deterministic stays on the sim-time channel
(`repro_torch.obs.tracing` with the default logical clock or explicit
simulated-cycle spans).

    >>> tr = wall_tracer()
    >>> with tr.span("io"):
    ...     pass
    >>> ev = tr.events[0]
    >>> ev.t1 >= ev.t0
    True

The device channel (`device_tracer()`) instruments the port's serving and
training path.  It is on only while a `torch.profiler` records: its spans
are the profiler's own ranges (`record_function`), on the clock of the
device's kernels in the same trace, and its counters sum Python numbers or
device tensors, read back by `snapshot()` alone.  They feed the chip
benchmark's per-layer metrics and never content-keyed records.  With no
profiler recording, every site gets `NULL_TRACER`: one flag read and a
no-op context, no kernel and no host-device sync.

    >>> device_tracer() is NULL_TRACER
    True
"""
from __future__ import annotations

import sys
import time

from repro_torch.obs.events import Sink
from repro_torch.obs.tracing import NULL_TRACER, Tracer


def wall_clock() -> float:
    """Monotonic wall seconds (the REALTIME channel's time base).

        >>> wall_clock() <= wall_clock()
        True
    """
    return time.perf_counter()


def wall_tracer(sink: Sink | None = None) -> Tracer:
    """A `Tracer` whose clock is the monotonic wall clock.

    Spans from a wall tracer measure real elapsed seconds and are
    therefore machine-dependent; confine their output to logs and
    dashboards, never to content-keyed stores.

        >>> tr = wall_tracer()
        >>> tr.count("pool.dispatch")
        >>> tr.snapshot()["counters"]
        {'pool.dispatch': 1.0}
    """
    return Tracer(sink=sink, clock=time.perf_counter)


class DeviceTracer:
    """The device channel's recorder (one a process: `DEVICE_TRACER`).

    `span(name, **attrs)` is a `torch.profiler.record_function` range; the
    attributes become its args string ("wave=3"), so the spans of one wave
    or step share an identifier, and nesting comes from the timeline.  The
    profiler keeps and exports the spans; nothing is held here.
    `count(name, n)` adds a Python number, a tensor (summed on its device)
    or a function of no arguments giving either, called only here, so a
    count that needs device work costs nothing while tracing is off.

        >>> import torch
        >>> tr = DeviceTracer()
        >>> tr.count("rows", 3)
        >>> tr.count("rows", lambda: torch.tensor([True, False]).sum())
        >>> tr.snapshot()["counters"]
        {'rows': 4.0}
        >>> tr.reset()
        >>> tr.snapshot()["counters"]
        {}
    """

    def __init__(self):
        self._counts: dict = {}

    def span(self, name: str, **attrs):
        from torch.autograd.profiler import record_function
        args = ",".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        return record_function(name, args or None)

    def count(self, name: str, n=1) -> None:
        if callable(n):
            n = n()
        held = self._counts.get(name)
        self._counts[name] = n if held is None else held + n

    def snapshot(self) -> dict:
        """The counters as floats (each tensor read back here), in the
        sim-time channel's layout."""
        return {"counters": {k: float(v) for k, v in
                             sorted(self._counts.items())},
                "histograms": {}}

    def reset(self) -> None:
        self._counts.clear()


DEVICE_TRACER = DeviceTracer()


def device_tracer():
    """`DEVICE_TRACER` while a `torch.profiler` records (the flag torch
    keeps for such checks), else `NULL_TRACER`.  No profiler can record
    before torch's profiler module is loaded, so a process without torch
    never imports it here."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and prof._is_profiler_enabled:
        return DEVICE_TRACER
    return NULL_TRACER
