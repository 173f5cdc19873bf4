"""Stream Step 5.2: activation memory usage tracing.

Once CN start/end times are known, the activation memory utilization is
traced through time from the per-CN attributes: output space is allocated
when a CN starts, exclusively-used inputs are freed when it finishes; for
inter-core transfers the consumer allocates at communication start and the
producer frees at communication end (paper Sec. III-F). The peak of the
summed per-core trace is the peak memory usage (paper Fig. 7 bottom).

Events are (time, +/- bytes, core, kind) with kind in {'act', 'weight'};
filtering on 'act' gives the paper's activation trace, no filter gives the
total on-chip footprint (activations + resident weights).
"""
from __future__ import annotations

import numpy as np


def trace(mem_events, n_cores: int | None = None, kind: str | None = None):
    """Return (times, total_usage, per_core_usage) cumulative traces."""
    ev = [e for e in mem_events if kind is None or e[3] == kind]
    if not ev:
        return np.zeros(1), np.zeros(1), np.zeros((1, 1))
    ev.sort(key=lambda e: e[0])
    n_cores = n_cores or (max(e[2] for e in ev) + 1)
    times, totals, per_core = [], [], []
    cur = np.zeros(n_cores)
    for t, delta, core, _ in ev:
        cur[core] += delta
        times.append(t)
        totals.append(cur.sum())
        per_core.append(cur.copy())
    return np.array(times), np.array(totals), np.array(per_core)


def peak_memory(mem_events, kind: str | None = None) -> float:
    ev = [e for e in mem_events if kind is None or e[3] == kind]
    if not ev:
        return 0.0
    ev.sort(key=lambda e: e[0])
    cur = peak = 0.0
    for _, delta, _, _ in ev:
        cur += delta
        peak = max(peak, cur)
    return peak
