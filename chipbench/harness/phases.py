"""What the program records itself in a `--trace 1` run: its phase spans
and its device channel's counters (`repro_torch.obs.realtime`).

The spans are `torch.profiler.record_function` ranges on the thread that
drove the run, so `Trace.from_profiler` keeps them in `Trace.host` beside
that thread's operations.  The counters count only while a profiler
records, so after the window they hold the profiled waves or steps.  A
program without the device channel records neither, and every reader of
this module then finds nothing.
"""
from __future__ import annotations

from harness.trace import merged


def _length(intervals) -> int:
    return sum(e - s for s, e in intervals)


def _overlap(a: list, b: list) -> int:
    """Nanoseconds common to two lists of sorted disjoint intervals."""
    out, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(0, hi - lo)
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_inside_ns(trace, name: str):
    """Nanoseconds of the traced window in which no device operation ran
    and the driving thread was inside a span named `name`; None where the
    trace holds no such span."""
    found = [(s, e) for n, s, e in trace.host if n == name]
    if not found:
        return None
    lo, hi = trace.window()
    inside = merged(found, lo, hi)
    busy = merged([(s, e) for _, s, e in trace.device], lo, hi)
    return _length(inside) - _overlap(inside, busy)


def idle_share(trace, name: str):
    """100 x `idle_inside_ns` over the traced window (the window that
    `idle_share.serve` and `idle_share.train` divide by)."""
    ns = idle_inside_ns(trace, name)
    if ns is None:
        return None
    lo, hi = trace.window()
    return 100.0 * ns / (hi - lo)


def program_counters() -> dict:
    """The device channel's counters ({} without the channel)."""
    try:
        from repro_torch.obs import realtime
    except ImportError:
        return {}
    tracer = getattr(realtime, "DEVICE_TRACER", None)
    return {} if tracer is None else tracer.snapshot()["counters"]
