"""Schedule race detector: validate a recorded schedule trace against the
resource and ordering invariants the event loop promises.

`ScheduleEngine` and `schedule_reference` are kept bit-identical by golden
tests, but bit-identity cannot see a bug both implementations share — a
double-booked core, a consumer starting before its producer's transfer
lands, a residency FIFO silently exceeding SRAM.  `validate_trace` checks
the *trace itself* against the model:

* ``core-exclusivity`` — no two CNs overlap on any core (each core is a
  single in-order execution resource).
* ``dram-exclusivity`` — off-chip access nodes never overlap on the single
  shared DRAM port.
* ``segment-monotonicity`` — no CN of fused stack *s* starts before every
  CN of stacks < *s* has finished: the barrier invariant that
  segment-prefix checkpointing relies on to snapshot/resume.
* ``dependency-order`` — every consumer starts at or after its producers
  finish, and for cross-core data edges at or after the recorded transfer
  lands on the consumer's core.
* ``channel-exclusivity`` — per-hop occupancies never overlap on any
  topology channel (or, for the flat-bus architecture, transfer envelopes
  never overlap on the one shared bus).
* ``memory-capacity`` — replaying `mem_events` in emission order never
  exceeds a core's activation or weight SRAM capacity (nor goes negative).

On success it returns a small report dict (counts per checked dimension);
on failure it raises `TraceValidationError` naming the violated invariant:

    >>> issubclass(TraceValidationError, ValueError)
    True
    >>> from repro_torch.configs.paper_workloads import fsrcnn
    >>> from repro_torch.core import CostModel, build_graph
    >>> from repro_torch.core.allocator import manual_pingpong
    >>> from repro_torch.core.scheduler import schedule
    >>> from repro_torch.hw.catalog import mc_hom_tpu
    >>> w, acc = fsrcnn(), mc_hom_tpu()
    >>> graph = build_graph(w, acc, ("tile", 4, 1))
    >>> res = schedule(graph, CostModel(w, acc), manual_pingpong(w, acc), acc)
    >>> report = validate_trace(res, graph, acc, workload=w)
    >>> report["cns"] == graph.n and report["edges"] > 0
    True
"""
from __future__ import annotations

import math

from repro_torch.core.scheduler import _segments_from_arrays

INVARIANTS = (
    "core-exclusivity", "dram-exclusivity", "segment-monotonicity",
    "dependency-order", "channel-exclusivity", "memory-capacity",
)


class TraceValidationError(ValueError):
    """A schedule trace violates one of the model's invariants.

    `invariant` names the violated check (one of `INVARIANTS`); the message
    is prefixed ``[<invariant>]`` so failures read unambiguously in CI.
    """

    def __init__(self, invariant: str, message: str):
        super().__init__(f"[{invariant}] {message}")
        self.invariant = invariant


def _fail(invariant: str, message: str) -> None:
    raise TraceValidationError(invariant, message)


def _check_exclusive(intervals, invariant: str, resource: str,
                     tol: float) -> None:
    """No two (start, end, tag) intervals may overlap on one resource."""
    prev_e, prev_tag = -math.inf, None
    for s, e, tag in sorted(intervals, key=lambda iv: (iv[0], iv[1])):
        if s < prev_e - tol:
            _fail(invariant,
                  f"{resource}: {tag} starts at {s:.6g} while {prev_tag} "
                  f"still occupies it until {prev_e:.6g}")
        if e > prev_e:
            prev_e, prev_tag = e, tag


def validate_trace(result, graph, accelerator, workload=None, *,
                   segment: bool = True,
                   strict_layers: bool = False) -> dict:
    """Check a recorded `ScheduleResult` against the schedule invariants.

    `result` must come from a ``record=True`` schedule of `graph` on
    `accelerator`; `segment`/`strict_layers` must match the scheduling call
    so the fused-stack partition is re-derived identically.  `workload` is
    needed only for the segment-monotonicity check under ``segment=True``
    (the partition depends on layer weight footprints); without it that
    check is skipped and listed in the report's ``skipped``.

    Returns a report dict (counts per checked dimension) on success; raises
    `TraceValidationError` on the first violated invariant, `ValueError`
    if the trace was not recorded.
    """
    n = graph.n
    n_cores = accelerator.n_cores
    total = sum(len(ivs) for ivs in result.core_intervals)
    if total != n:
        raise ValueError(
            f"trace records {total} core intervals for {n} CNs — "
            "validate_trace needs a record=True schedule of this graph")
    tol = 1e-6 * max(1.0, result.latency_cc)
    skipped: list[str] = []

    # ---- per-CN start/end/core from the core trace -----------------------
    start = [0.0] * n
    end = [0.0] * n
    cn_core = [0] * n
    for core, ivs in enumerate(result.core_intervals):
        for s, e, i in ivs:
            start[i], end[i], cn_core[i] = s, e, core

    # ---- core exclusivity ------------------------------------------------
    for core, ivs in enumerate(result.core_intervals):
        _check_exclusive([(s, e, f"CN {i}") for s, e, i in ivs],
                         "core-exclusivity", f"core {core}", tol)

    # ---- DRAM-port exclusivity ------------------------------------------
    _check_exclusive(
        [(s, e, f"{kind}({b}B)") for s, e, kind, b in result.dram_intervals],
        "dram-exclusivity", "DRAM port", tol)

    # ---- segment-barrier monotonicity -----------------------------------
    layer_of = graph.layer.tolist()
    n_segments = 1
    if strict_layers:
        seg_of = layer_of
    elif segment and workload is None:
        seg_of = None
        skipped.append("segment-monotonicity (needs workload)")
    elif segment:
        n_layers = len(workload.layers)
        alloc = [0] * n_layers
        for i in range(n):
            alloc[layer_of[i]] = cn_core[i]
        seg_of_layer = _segments_from_arrays(
            alloc, [layer.weight_bytes for layer in workload.layers.values()],
            [c.weight_mem_bytes for c in accelerator.cores])
        seg_of = [int(seg_of_layer[l]) for l in layer_of]
    else:
        seg_of = [0] * n
    if seg_of is not None and n:
        n_segments = max(seg_of) + 1
        seg_min_start = [math.inf] * n_segments
        seg_max_end = [0.0] * n_segments
        seg_first = [-1] * n_segments
        for i in range(n):
            s = seg_of[i]
            if start[i] < seg_min_start[s]:
                seg_min_start[s], seg_first[s] = start[i], i
            if end[i] > seg_max_end[s]:
                seg_max_end[s] = end[i]
        barrier = 0.0
        for s in range(1, n_segments):
            barrier = max(barrier, seg_max_end[s - 1])
            if seg_min_start[s] < barrier - tol:
                _fail("segment-monotonicity",
                      f"CN {seg_first[s]} of fused stack {s} starts at "
                      f"{seg_min_start[s]:.6g} before the stack-{s} barrier "
                      f"{barrier:.6g} (every CN of stacks < {s} must finish "
                      "first — segment checkpointing depends on this)")

    # ---- dependency ordering --------------------------------------------
    shared_l1 = accelerator.comm_style == "shared_mem"
    arrival: dict[tuple[int, int], float] = {}
    for s, e, u, v, _b in result.comm_intervals:
        if s < end[u] - tol:
            _fail("dependency-order",
                  f"transfer of CN {u}'s output starts at {s:.6g} before "
                  f"the producer finishes at {end[u]:.6g}")
        arrival[(u, cn_core[v])] = e
    n_edges = 0
    for v in range(n):
        for u in graph.preds[v]:
            n_edges += 1
            e_bytes = graph.edge_bytes[(u, v)]
            if shared_l1 or e_bytes == 0 or cn_core[u] == cn_core[v]:
                need, how = end[u], f"producer CN {u} finishes"
            else:
                got = arrival.get((u, cn_core[v]))
                if got is None:
                    _fail("dependency-order",
                          f"no transfer recorded for cross-core edge "
                          f"CN {u} (core {cn_core[u]}) -> CN {v} "
                          f"(core {cn_core[v]})")
                need = got
                how = f"CN {u}'s transfer lands on core {cn_core[v]}"
            if start[v] < need - tol:
                _fail("dependency-order",
                      f"CN {v} starts at {start[v]:.6g} before {how} "
                      f"at {need:.6g}")

    # ---- channel / bus exclusivity --------------------------------------
    chan_intervals = getattr(result, "chan_intervals", None) or []
    n_channels = 0
    if chan_intervals:
        per_chan: dict[int, list] = {}
        for s, e, ch, b in chan_intervals:
            per_chan.setdefault(ch, []).append((s, e, f"hop({b}B)"))
        n_channels = len(per_chan)
        for ch in sorted(per_chan):
            _check_exclusive(per_chan[ch], "channel-exclusivity",
                             f"channel {ch}", tol)
    elif not shared_l1 and accelerator.topology is None:
        n_channels = 1
        _check_exclusive(
            [(s, e, f"CN {u}->CN {v}")
             for s, e, u, v, _b in result.comm_intervals],
            "channel-exclusivity", "shared bus", tol)

    # ---- memory capacity (emission-order replay) ------------------------
    # Events are replayed in emission order, not time order: the engine
    # clamps in simulation order, and paired events (a weight fetch's +hold
    # followed by its -evicted at the same timestamp) are emitted
    # alloc-first — so consecutive events sharing (time, core, kind) are
    # applied as one atomic group before checking the capacity bound.
    if shared_l1:
        act_cap = [0.0] * n_cores
        act_cap[0] = float(sum(c.act_mem_bytes for c in accelerator.cores))
    else:
        act_cap = [float(c.act_mem_bytes) for c in accelerator.cores]
    w_cap = [float(c.weight_mem_bytes) for c in accelerator.cores]
    events = result.mem_events
    used: dict[tuple[int, str], float] = {}
    idx = 0
    while idx < len(events):
        t, _, core, kind = events[idx]
        j = idx
        delta = 0.0
        while j < len(events) and events[j][0] == t \
                and events[j][2] == core and events[j][3] == kind:
            delta += events[j][1]
            j += 1
        level = used.get((core, kind), 0.0) + delta
        used[(core, kind)] = level
        cap = act_cap[core] if kind == "act" else w_cap[core]
        btol = 1e-6 * max(1.0, cap)
        if level > cap + btol:
            _fail("memory-capacity",
                  f"{kind} memory on core {core} reaches {level:.6g} B at "
                  f"t={t:.6g}, over its {cap:.6g} B capacity")
        if level < -btol:
            _fail("memory-capacity",
                  f"{kind} memory on core {core} goes negative "
                  f"({level:.6g} B) at t={t:.6g}: more freed than allocated")
        idx = j

    return {
        "cns": n,
        "cores": n_cores,
        "edges": n_edges,
        "segments": n_segments,
        "channels": n_channels,
        "comm_intervals": len(result.comm_intervals),
        "dram_intervals": len(result.dram_intervals),
        "mem_events": len(events),
        "skipped": skipped,
    }
