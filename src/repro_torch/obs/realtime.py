"""Wall-time observability sink — the REALTIME half of the two-channel split.

This is the only module of `repro_torch.obs` allowed to read the wall clock
(it is pinned REALTIME in `repro_torch.analysis.staticcheck.tiers`, so the
linter's wall-clock rule does not apply here).  Wall-time spans wrap
*real execution* — worker wall time, store I/O, pool dispatch — and are
strictly for operator eyes: nothing recorded through a wall tracer may
reach content-keyed records, golden traces, or BENCH metric values.
Everything deterministic stays on the sim-time channel
(`repro_torch.obs.tracing` with the default logical clock or explicit
simulated-cycle spans).

    >>> tr = wall_tracer()
    >>> with tr.span("io"):
    ...     pass
    >>> ev = tr.events[0]
    >>> ev.t1 >= ev.t0
    True
"""
from __future__ import annotations

import time

from repro_torch.obs.events import Sink
from repro_torch.obs.tracing import Tracer


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
