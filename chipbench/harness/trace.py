"""The profiler's trace of a `--trace 1` run, reduced to plain intervals.

`Trace.from_profiler` keeps three lists of (name, start ns, end ns): the
operations that ran on the device (kernels, copies, sets), the host's
operations on the thread that drove the run, and the harness's own spans
(names starting with "chipbench.", from `torch.profiler.record_function`).
Everything else reads those lists, so the arithmetic is tested on
synthetic intervals.
"""
from __future__ import annotations

import collections
import dataclasses
import re

SPAN_PREFIX = "chipbench."
WINDOW = SPAN_PREFIX + "window"


@dataclasses.dataclass
class Trace:
    device: list            # (name, start_ns, end_ns)
    host: list
    spans: list

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType
        device, host, spans = [], [], []
        threads = collections.Counter()
        raw = []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not name.startswith(SPAN_PREFIX) and \
                        not e.is_user_annotation():
                    device.append((name, start, end))
            elif e.device_type() == DeviceType.CPU:
                if name.startswith(SPAN_PREFIX):
                    spans.append((name, start, end))
                    threads[e.start_thread_id()] += 1
                raw.append((name, start, end, e.start_thread_id()))
        main = threads.most_common(1)[0][0] if threads else None
        host = [(n, s, t) for n, s, t, th in raw
                if th == main and not n.startswith(SPAN_PREFIX)]
        return cls(sorted(device, key=lambda x: x[1]),
                   sorted(host, key=lambda x: x[1]),
                   sorted(spans, key=lambda x: x[1]))

    def intervals(self, name: str) -> list:
        return [(s, e) for n, s, e in self.spans if n == name]

    def window(self) -> tuple:
        """The traced window: the harness's "chipbench.window" span."""
        found = self.intervals(WINDOW)
        if len(found) != 1:
            raise ValueError(f"{len(found)} {WINDOW} spans in the trace")
        return found[0]


def merged(intervals, lo: int, hi: int) -> list:
    """The union of `intervals` ((start, end) pairs) clipped to [lo, hi],
    as sorted disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_ns(trace: Trace, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] in which some device operation ran."""
    return sum(e - s for s, e in merged(
        [(s, e) for _, s, e in trace.device], lo, hi))


def _inside(t: int, intervals) -> bool:
    return any(s <= t < e for s, e in intervals)


def kernel_ns(trace: Trace, pattern: str, span: str) -> tuple:
    """(device ns, launches) of the device operations whose name matches
    `pattern` (a regular expression) and that start inside a span named
    `span`."""
    where = trace.intervals(span)
    rx = re.compile(pattern)
    hits = [e - s for n, s, e in trace.device
            if rx.search(n) and _inside(s, where)]
    return sum(hits), len(hits)


def device_ops(trace: Trace, top: int = 10) -> list:
    """[name, seconds] of the device operations that took most time in the
    window, summed by name, largest first."""
    lo, hi = trace.window()
    total = collections.Counter()
    for n, s, e in trace.device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            total[n[:160]] += e - s
    return [[n, ns / 1e9] for n, ns in total.most_common(top)]


def _host_labels(trace: Trace, times: list) -> list:
    """The innermost host operation or harness span open at each of the
    sorted `times` ("host" where none is): one sweep, since the operations
    of one thread nest."""
    events = sorted(((s, e, n) for n, s, e in trace.host + trace.spans
                     if n != WINDOW), key=lambda x: (x[0], -x[1]))
    stack, out, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host")
    return out


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """[label, seconds] of the window's time with nothing on the device,
    summed by what the host was doing at each gap's middle, longest
    first."""
    lo, hi = trace.window()
    busy = merged([(s, e) for _, s, e in trace.device], lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    labels = _host_labels(trace, [(a + b) // 2 for a, b in idle])
    total = collections.Counter()
    for (a, b), n in zip(idle, labels):
        total[n[:160]] += b - a
    return [[n, ns / 1e9] for n, ns in total.most_common(top)]
