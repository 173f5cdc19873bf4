"""Lower recorded schedules and serving runs to Chrome trace-event JSON.

`ScheduleResult` already records everything the paper's activity-level
validation plots need — per-core compute intervals, channel hops, the
DRAM port, the activation-memory event stream — and the serving
simulator records per-request lifecycles plus engine steps.  This module
lowers both into the Chrome trace-event format (the JSON understood by
``chrome://tracing`` and Perfetto): one lane (``tid``) per core, per
link channel, and for the DRAM port, ``X`` complete events per busy
interval, ``C`` counter tracks for activation bytes and batch occupancy,
and a marker lane for fused-segment windows.

Cycles are emitted directly as trace microseconds (1 cc -> 1 us): the
viewers only need a consistent unit, and integer-exact cycle values keep
the export a pure function of the recorded result — same schedule, byte-
identical JSON (`chrome_trace_json` sorts keys and pins separators).

    >>> from repro_torch.configs.paper_workloads import fsrcnn
    >>> from repro_torch.core import CostModel, build_graph
    >>> from repro_torch.core.scheduler import ScheduleEngine
    >>> from repro_torch.hw.catalog import mc_hom_tpu
    >>> w, acc = fsrcnn(), mc_hom_tpu()
    >>> graph = build_graph(w, acc, ("tile", 8, 1))
    >>> engine = ScheduleEngine(graph, CostModel(w, acc), acc)
    >>> events, res = trace_schedule(engine, [0, 1, 0, 1, 0, 1, 0, 1])
    >>> validate_trace_events(events)
    []
    >>> chrome_trace_json(events) == chrome_trace_json(events)
    True
"""
from __future__ import annotations

import json
from typing import Sequence

import numpy as np

from repro_torch.core.scheduler import (ScheduleResult, ScheduleEngine,
                                  compute_segments)


def _meta(pid: int, tid: int | None, name: str, value) -> dict:
    # chrome metadata args key: 'name' for *_name, 'sort_index' for *_sort_index
    key = "sort_index" if name.endswith("sort_index") else "name"
    ev = {"ph": "M", "pid": pid, "name": name, "args": {key: value}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def _lane(pid: int, tid: int, name: str) -> list[dict]:
    return [_meta(pid, tid, "thread_name", name),
            _meta(pid, tid, "thread_sort_index", tid)]


def schedule_trace_events(
    result: ScheduleResult,
    core_names: Sequence[str] | None = None,
    segments: "Sequence[tuple[str, float, float]] | None" = None,
    pid: int = 0,
) -> list[dict]:
    """Trace events of one recorded schedule: one lane per core, per link
    channel (or the flat bus), and for the DRAM port, plus activation-byte
    counters and optional fused-segment markers.

    A pure function of the recorded `ScheduleResult` — calling it twice on
    the same result yields the identical event list.

        >>> import numpy as np
        >>> res = ScheduleResult(
        ...     latency_cc=4.0, energy_pj=1.0, energy_breakdown={},
        ...     peak_mem_bytes=0.0, act_peak_bytes=0.0,
        ...     core_intervals=[[(0.0, 4.0, 0)], []],
        ...     comm_intervals=[(1.0, 2.0, 0, 1, 64)], dram_intervals=[],
        ...     core_busy=np.zeros(2), mem_events=[])
        >>> evs = schedule_trace_events(res, segments=[("segment 0", 0.0, 4.0)])
        >>> sorted({e["ph"] for e in evs})
        ['M', 'X']
        >>> [e["name"] for e in evs if e["ph"] == "X"]
        ['cn0', '0->1', 'segment 0']
    """
    n_cores = len(result.core_intervals)
    chan_ids = sorted({c for (_, _, c, _) in result.chan_intervals})
    chan_tid = {c: n_cores + i for i, c in enumerate(chan_ids)}
    bus_tid = n_cores if (not chan_ids and result.comm_intervals) else None
    dram_tid = n_cores + max(len(chan_ids), 1 if bus_tid is not None else 0)
    seg_tid = dram_tid + 1

    events: list[dict] = [_meta(pid, None, "process_name", "schedule"),
                          _meta(pid, None, "process_sort_index", pid)]
    for i in range(n_cores):
        name = core_names[i] if core_names else f"core{i}"
        events += _lane(pid, i, name)
    for c in chan_ids:
        events += _lane(pid, chan_tid[c], f"chan{c}")
    if bus_tid is not None:
        events += _lane(pid, bus_tid, "bus")
    events += _lane(pid, dram_tid, "dram")
    if segments:
        events += _lane(pid, seg_tid, "segments")

    for i, intervals in enumerate(result.core_intervals):
        for (s, e, cn) in intervals:
            events.append({"name": f"cn{cn}", "ph": "X", "pid": pid,
                           "tid": i, "ts": s, "dur": e - s,
                           "args": {"cn": cn}})
    if chan_ids:
        for (s, e, c, nbytes) in result.chan_intervals:
            events.append({"name": "xfer", "ph": "X", "pid": pid,
                           "tid": chan_tid[c], "ts": s, "dur": e - s,
                           "args": {"bytes": nbytes}})
    elif bus_tid is not None:
        for (s, e, u, v, nbytes) in result.comm_intervals:
            events.append({"name": f"{u}->{v}", "ph": "X", "pid": pid,
                           "tid": bus_tid, "ts": s, "dur": e - s,
                           "args": {"bytes": nbytes}})
    for (s, e, kind, nbytes) in result.dram_intervals:
        events.append({"name": kind, "ph": "X", "pid": pid, "tid": dram_tid,
                       "ts": s, "dur": e - s, "args": {"bytes": nbytes}})
    for (label, s, e) in segments or ():
        events.append({"name": label, "ph": "X", "pid": pid, "tid": seg_tid,
                       "ts": s, "dur": e - s, "args": {}})

    # activation-memory counters: running per-core totals from mem_events
    totals = [0.0] * n_cores
    for (t, delta, core, kind) in result.mem_events:
        if kind != "act":
            continue
        totals[core] += delta
        events.append({"name": f"act_bytes[core{core}]", "ph": "C",
                       "pid": pid, "ts": t,
                       "args": {"bytes": totals[core]}})
    return events


def trace_schedule(engine: ScheduleEngine, allocation,
                   priority: str = "latency", strict_layers: bool = False,
                   pid: int = 0) -> tuple[list[dict], ScheduleResult]:
    """Schedule one allocation with full trace recording and lower it.

    The high-level entry point: runs `engine.schedule(..., record=True)`,
    derives the fused-segment windows (`compute_segments` + the recorded
    intervals) and per-core labels, and returns ``(events, result)``.

        >>> from repro_torch.configs.paper_workloads import fsrcnn
        >>> from repro_torch.core import CostModel, build_graph
        >>> from repro_torch.core.scheduler import ScheduleEngine
        >>> from repro_torch.hw.catalog import mc_hom_tpu
        >>> w, acc = fsrcnn(), mc_hom_tpu()
        >>> graph = build_graph(w, acc, ("tile", 8, 1))
        >>> engine = ScheduleEngine(graph, CostModel(w, acc), acc)
        >>> events, res = trace_schedule(engine, [0, 1, 2, 3, 0, 1, 2, 3])
        >>> any(e.get("tid") == 0 and e["ph"] == "X" for e in events)
        True
    """
    alloc = np.asarray(allocation, dtype=np.int64)
    result = engine.schedule(alloc, priority, strict_layers=strict_layers)
    workload = engine.cost_model.workload
    if strict_layers:
        seg_of_layer = np.arange(len(workload.layers), dtype=np.int64)
    else:
        seg_of_layer = compute_segments(workload, alloc, engine.accelerator)
    seg_of_cn = seg_of_layer[engine.graph.layer]
    lo: dict[int, float] = {}
    hi: dict[int, float] = {}
    for intervals in result.core_intervals:
        for (s, e, cn) in intervals:
            g = int(seg_of_cn[cn])
            if g not in lo or s < lo[g]:
                lo[g] = s
            if g not in hi or e > hi[g]:
                hi[g] = e
    segments = [(f"segment {g}", lo[g], hi[g]) for g in sorted(lo)]
    cores = engine.accelerator.cores
    core_names = [f"core{i} ({cores[i].core_type})" for i in range(len(cores))]
    return (schedule_trace_events(result, core_names=core_names,
                                  segments=segments, pid=pid), result)


def serving_trace_events(sim, pid: int = 1,
                         max_request_lanes: int = 256) -> list[dict]:
    """Trace events of one serving-simulator run: an engine lane of
    prefill/decode steps, a batch-occupancy counter, and one lane per
    request showing its queue -> serve lifecycle.

    Request lanes are capped at `max_request_lanes` (the engine lane and
    occupancy counter always cover the full run).

        >>> from repro_torch.serve.arrivals import uniform_trace
        >>> from repro_torch.serve.simulator import PhaseCosts, simulate
        >>> costs = PhaseCosts(prefill_cc=100.0, prefill_pj=2.0,
        ...                    decode_cc=10.0, decode_pj=1.0)
        >>> sim = simulate(uniform_trace(0.0, 2, decode_tokens=2), costs, 2)
        >>> evs = serving_trace_events(sim)
        >>> [e["name"] for e in evs if e["ph"] == "X" and e["tid"] == 0]
        ['prefill', 'decode', 'decode']
        >>> validate_trace_events(evs)
        []
    """
    events: list[dict] = [_meta(pid, None, "process_name", "serving"),
                          _meta(pid, None, "process_sort_index", pid)]
    events += _lane(pid, 0, "engine")
    requests = sim.requests[:max_request_lanes]
    for idx, req in enumerate(requests):
        events += _lane(pid, 1 + idx, f"req{req.rid}")
    for (s, e, kind, n_active) in getattr(sim, "steps", ()):
        events.append({"name": kind, "ph": "X", "pid": pid, "tid": 0,
                       "ts": s, "dur": e - s,
                       "args": {"active": n_active}})
        events.append({"name": "batch_occupancy", "ph": "C", "pid": pid,
                       "ts": s, "args": {"active": n_active}})
    for idx, req in enumerate(requests):
        tid = 1 + idx
        if req.queue_cc > 0:
            events.append({"name": "queue", "ph": "X", "pid": pid,
                           "tid": tid, "ts": req.t_arrive_cc,
                           "dur": req.queue_cc, "args": {"rid": req.rid}})
        events.append({"name": "serve", "ph": "X", "pid": pid, "tid": tid,
                       "ts": req.t_admit_cc,
                       "dur": req.t_done_cc - req.t_admit_cc,
                       "args": {"rid": req.rid,
                                "latency_cc": req.latency_cc,
                                "energy_pj": req.energy_pj}})
    return events


def chrome_trace(events: Sequence[dict]) -> dict:
    """Wrap an event list into the Chrome trace-event JSON object form.

        >>> chrome_trace([])["traceEvents"]
        []
    """
    return {"traceEvents": list(events), "displayTimeUnit": "ms"}


def chrome_trace_json(events: Sequence[dict]) -> str:
    """Serialize events to the canonical (byte-stable) trace JSON string:
    sorted keys, pinned separators, trailing newline.

        >>> chrome_trace_json([])
        '{"displayTimeUnit": "ms", "traceEvents": []}\\n'
    """
    return json.dumps(chrome_trace(events), sort_keys=True,
                      separators=(", ", ": ")) + "\n"


def write_chrome_trace(events: Sequence[dict], path: str) -> str:
    """Write the canonical trace JSON to `path`; returns the path.

        >>> import os, tempfile
        >>> p = os.path.join(tempfile.mkdtemp(), "trace.json")
        >>> _ = write_chrome_trace([], p)
        >>> json.load(open(p))["traceEvents"]
        []
    """
    with open(path, "w") as fh:
        fh.write(chrome_trace_json(events))
    return path


_META_KEYS = {"process_name", "process_sort_index", "thread_name",
              "thread_sort_index"}


def validate_trace_events(events: Sequence[dict]) -> list[str]:
    """Schema problems of an event list ([] when it is loadable).

    Checks the invariants chrome://tracing / Perfetto rely on: known
    phase codes, complete (`X`) events carrying non-negative ts/dur and a
    lane, counters carrying numeric args, metadata names from the known
    set.

        >>> validate_trace_events([{"ph": "X", "name": "a", "pid": 0,
        ...                         "tid": 0, "ts": 0.0, "dur": -1.0}])
        ['event 0: negative dur']
    """
    problems = []
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in ("X", "M", "C", "i"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if "name" not in ev or "pid" not in ev:
            problems.append(f"event {i}: missing name/pid")
            continue
        if ph == "X":
            if not all(k in ev for k in ("tid", "ts", "dur")):
                problems.append(f"event {i}: X without tid/ts/dur")
            elif ev["dur"] < 0:
                problems.append(f"event {i}: negative dur")
            elif ev["ts"] < 0:
                problems.append(f"event {i}: negative ts")
        elif ph == "C":
            args = ev.get("args")
            if not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                problems.append(f"event {i}: counter without numeric args")
        elif ph == "M" and ev["name"] not in _META_KEYS:
            problems.append(f"event {i}: unknown metadata {ev['name']!r}")
    return problems
