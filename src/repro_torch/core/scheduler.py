"""Stream Step 5.1: multi-core CN scheduling.

Event-list scheduler over the fine-grained CN graph. Resources:
  * each core (free-from time),
  * the shared inter-core communication bus — a *communication node* is
    inserted for every producer->consumer edge crossing cores; the bus serves
    nodes first-come-first-serve (contention).  With a cluster topology on
    the accelerator (`repro_torch.hw.topology`) the one bus becomes a set of
    channels — per-cluster local buses plus inter-cluster links — and a
    cross-cluster transfer occupies every channel on its route in order
    (hops x per-link latency/energy, FCFS per channel); a single-cluster
    topology degenerates to the flat bus bit-for-bit,
  * the shared off-chip DRAM port — *off-chip access nodes* model weight
    fetches (with FIFO eviction from the core's weight memory), first-layer
    input activations, and activation spills when a core's activation memory
    overflows, all FCFS on the port.

Two candidate-selection priorities (paper Fig. 8):
  * 'latency': pick the candidate whose predecessors finished earliest
    (its data has waited in memory the longest) -> maximizes core utilization;
  * 'memory' : pick the candidate from the deepest layer -> consume data as
    deep into the fused stack as possible for early discarding.

Two implementations share these semantics bit-for-bit:
  * `ScheduleEngine` — the array-native hot path: consumes the CN graph's CSR
    arrays and the cost model's dense tables, runs the event loop over flat
    Python lists (no `CN` object access, no dict-keyed edge lookups), and
    computes the memory peak with a vectorized cumulative trace. Build it
    once per (graph, cost model) and reuse it across all GA evaluations.
  * `schedule_reference` — the original object/dict implementation, kept as
    the golden oracle for equivalence tests.
`schedule()` keeps the seed's signature and dispatches to a `ScheduleEngine`
cached on the graph.

Incremental rescheduling (the GA fitness fast path): the event loop pops
CNs in strict fused-stack order — a CN of segment s+1 can only pop once
every segment-<=s CN is scheduled (predecessors never cross segments
forward, so some segment-<=s CN is always ready while any remains).  The
engine exploits this by snapshotting the complete loop state (core/bus/DRAM
free times, finish array, weight-residency FIFOs, activation accounting,
energy accumulators, ready set) at each segment barrier, keyed by the
allocation prefix that determined it.  A later schedule whose allocation
shares that prefix resumes from the deepest matching snapshot and replays
only the differing suffix — GA offspring, which differ from their parents
in one or two genes, pay only for the mutated tail.  Resumed schedules are
bit-identical to cold ones (the snapshot *is* the cold state).
"""
from __future__ import annotations

import heapq
from collections import OrderedDict
from typing import Sequence

import numpy as np

from repro_torch.core.costmodel import CostModel
from repro_torch.core.depgraph import CNGraph
from repro_torch.hw.accelerator import Accelerator

PREFETCH_DEPTH = 4.0  # external-input staging depth (quad-buffered prefetch)

_KIND_ACT, _KIND_WEIGHT = 0, 1
_KIND_NAMES = ("act", "weight")


class ScheduleResult:
    """Outcome of one multi-core schedule.

    `mem_events` (the (time, +/- bytes, core, kind) trace of paper Step 5.2)
    is materialized lazily from flat event buffers when the engine produced
    the result, so genome evaluations that only read latency/energy never pay
    for building the tuple list.
    """

    def __init__(self, latency_cc: float, energy_pj: float,
                 energy_breakdown: dict[str, float], peak_mem_bytes: float,
                 act_peak_bytes: float,
                 core_intervals: list[list[tuple[float, float, int]]],
                 comm_intervals: list[tuple[float, float, int, int, int]],
                 dram_intervals: list[tuple[float, float, str, int]],
                 core_busy: np.ndarray,
                 mem_events: list[tuple[float, float, int, str]] | None = None,
                 mem_buffers: tuple[list, list, list, list] | None = None,
                 chan_intervals: list[tuple[float, float, int, int]] | None = None):
        self.latency_cc = latency_cc
        self.energy_pj = energy_pj
        self.energy_breakdown = energy_breakdown
        self.peak_mem_bytes = peak_mem_bytes      # activations + resident weights
        self.act_peak_bytes = act_peak_bytes      # activations only
        self.core_intervals = core_intervals      # per core: (start, end, cn)
        self.comm_intervals = comm_intervals      # (s, e, u, v, bytes)
        self.dram_intervals = dram_intervals      # (s, e, kind, bytes)
        self.chan_intervals = chan_intervals or []  # per hop: (s, e, chan, bytes)
        self.core_busy = core_busy
        self._mem_events = mem_events
        self._mem_buffers = mem_buffers

    @property
    def mem_events(self) -> list[tuple[float, float, int, str]]:
        if self._mem_events is None:
            t, d, c, k = self._mem_buffers or ([], [], [], [])
            self._mem_events = [(t[i], d[i], c[i], _KIND_NAMES[k[i]])
                                for i in range(len(t))]
        return self._mem_events

    @property
    def edp(self) -> float:
        return self.latency_cc * self.energy_pj

    def utilization(self) -> np.ndarray:
        return self.core_busy / max(self.latency_cc, 1.0)


def compute_segments(workload, allocation, accelerator) -> np.ndarray:
    """Partition layers into fused stacks bounded by on-core weight capacity.

    Depth-first interleaving across layers whose combined weights exceed the
    allocated cores' weight memories would thrash the FIFO (refetching weights
    once per CN band). Real depth-first systems (DepFiN [15], DeFiNES [27],
    TVM cascading [37]) bound each fused stack so its weights stay resident;
    we do the same: greedy topological cut whenever a core's accumulated
    weight footprint would overflow. Layers whose weights alone exceed the
    capacity get their own stack (weights stream exactly once).
    """
    alloc = np.asarray(allocation, dtype=np.int64)
    weight_bytes = [layer.weight_bytes for layer in workload.layers.values()]
    caps = [c.weight_mem_bytes for c in accelerator.cores]
    return _segments_from_arrays(alloc.tolist(), weight_bytes, caps)


def _segments_from_arrays(alloc: list[int], layer_weight_bytes: list[int],
                          core_weight_caps: list[int]) -> np.ndarray:
    acc_w: dict[int, float] = {}
    seg = 0
    seg_of = np.zeros(len(layer_weight_bytes), dtype=np.int64)
    for lid, wb in enumerate(layer_weight_bytes):
        core = alloc[lid]
        cap = core_weight_caps[core]
        if wb > 0 and cap > 0:
            hold = min(wb, cap)
            if acc_w.get(core, 0.0) + hold > cap and acc_w.get(core, 0.0) > 0:
                seg += 1
                acc_w = {}
            acc_w[core] = acc_w.get(core, 0.0) + hold
        seg_of[lid] = seg
    return seg_of


class ScheduleEngine:
    """Precomputed array-native scheduling engine.

    Binds one CN graph (CSR + attribute arrays) to one cost model's dense
    tables and the accelerator's constants, all converted to flat Python
    lists (fastest scalar access in the interpreter loop). `schedule()` is
    then a pure event loop over these buffers — the intended use is one
    engine shared by every genome evaluation of a GA run.
    """

    # the canonical checkpoint-counter set (ckpt_stats keys) — aggregators
    # initialize from this instead of hand-duplicating the key list
    CKPT_COUNTERS = ("resume_hits", "cold_starts", "snapshots",
                     "cns_skipped", "cns_scheduled")

    def __init__(self, graph: CNGraph, cost_model: CostModel,
                 accelerator: Accelerator | None = None):
        acc = accelerator or cost_model.accelerator
        self.graph = graph
        self.cost_model = cost_model
        self.accelerator = acc
        self.n = graph.n
        # optional sim-time tracer (duck-typed like the JAX package's
        # repro.obs.Tracer); None keeps schedule() free of any tracing
        # overhead beyond one attribute read per call
        self.tracer = None
        tables = cost_model.precompute(graph, acc)
        self.tables = tables

        # per-CN x core cost rows: (cycles, e_compute, e_sram) or None when
        # the core cannot run the CN — one index + unpack in the hot loop.
        # Rows are built once per unique signature and shared by every CN of
        # that signature (n_sig << n).
        cyc = tables.cycles.tolist()
        ecp = tables.e_compute.tolist()
        esr = tables.e_sram.tolist()
        feas = tables.feasible.tolist()
        sig_rows = [
            tuple((cyc[s][c], ecp[s][c], esr[s][c]) if feas[s][c] else None
                  for c in range(acc.n_cores))
            for s in range(tables.n_signatures)]
        self._cost_rows = [sig_rows[s] for s in tables.sig_of_cn.tolist()]

        # CSR adjacency unpacked to per-CN tuples: one index + unpack per
        # edge in the hot loop (insertion order preserved — bus FCFS order).
        # Cached on the graph, so engines for different accelerators on the
        # same graph share them.
        hot = graph.hot_lists
        self._pred_pairs = graph.pred_pairs
        self._pred_zero, self._pred_data = graph.pred_split
        self._succ_of = graph.succ_tuples
        self._indeg0 = hot["indeg"]
        self._zeros_n = [0] * self.n
        self._layer_arr = graph.layer                      # kept as ndarray for fancy indexing
        self._layer_of = hot["layer"]
        self._rank_of = hot["intra_rank"]
        # heap tie-break (layer, intra_rank, cn) packed into one int: integer
        # comparison of the codes is lexicographically identical to comparing
        # the tuples, and the low bits recover the CN id (field width sized
        # from n, since layer < n and intra_rank < n always hold)
        bits = max(self.n.bit_length(), 1)
        self._code_mask = (1 << bits) - 1
        self._heap_code = [(l << (2 * bits)) | (r << bits) | i for i, (l, r) in
                           enumerate(zip(self._layer_of, self._rank_of))]
        self._out_bytes = hot["out_bytes"]
        self._weight_bytes = hot["weight_bytes"]
        self._new_in_bytes = hot["new_in_bytes"]
        self._disc_bytes = hot["disc_bytes"]
        self._neg_layer = [-float(l) for l in self._layer_of]

        # workload / accelerator constants
        wl = cost_model.workload
        self.n_layers = len(wl.layers)
        self._layer_wb = [layer.weight_bytes for layer in wl.layers.values()]
        layer_external = [not layer.inputs for layer in wl.layers.values()]
        self._external_of = [layer_external[l] for l in self._layer_of]
        self._w_cap = [c.weight_mem_bytes for c in acc.cores]
        self._is_aimc = [c.core_type == "aimc" for c in acc.cores]
        self._shared_l1 = acc.comm_style == "shared_mem"
        # ---- cluster topology: per-transfer channel routes ----------------
        # With a topology the shared bus becomes a set of channels (per-
        # cluster local buses + inter-cluster links); routes[u_core][core]
        # is the tuple of channel ids a u->core transfer occupies in order.
        # A single-cluster topology routes everything over channel 0, whose
        # bandwidth/energy/FCFS arithmetic is bit-identical to the flat bus.
        if acc.topology is not None and not self._shared_l1:
            from repro_torch.hw.topology import build_channels
            self._chan_bw, self._chan_e, self._routes = build_channels(acc)
            self._n_chan = len(self._chan_bw)
        else:
            self._chan_bw = self._chan_e = self._routes = None
            self._n_chan = 0
        if self._shared_l1:
            self._act_cap0 = [0.0] * acc.n_cores
            self._act_cap0[0] = float(sum(c.act_mem_bytes for c in acc.cores))
        else:
            self._act_cap0 = [float(c.act_mem_bytes) for c in acc.cores]

        # ---- segment-prefix checkpointing ---------------------------------
        # Valid only when CN ids are grouped by nondecreasing layer and no
        # edge points to an earlier layer (both hold for every graph built by
        # `build_cn_graph`; checked, not assumed) — then "all CNs of layers
        # < L scheduled" is exactly "all CN ids < first_cn_of_layer[L]".
        layer_sorted = bool(np.all(np.diff(graph.layer) >= 0)) if self.n else False
        edges_forward = True
        if graph.pred_indices.size:
            cons_layer = np.repeat(graph.layer, np.diff(graph.pred_indptr))
            edges_forward = bool(
                np.all(graph.layer[graph.pred_indices] <= cons_layer))
        self._ckpt_ok = layer_sorted and edges_forward and self.n > 0
        self._first_cn_of_layer = (
            np.searchsorted(graph.layer, np.arange(self.n_layers)).tolist()
            if self._ckpt_ok else None)
        self._strict_starts = list(range(self.n_layers))
        self.checkpointing = True          # default for record=False schedules
        self.ckpt_capacity = 512           # snapshots kept per engine (LRU)
        # snapshot spacing: skip barriers closer than this many CNs to the
        # previous snapshot, bounding per-schedule snapshot overhead while
        # keeping resume granularity at ~1/16 of the network
        self._ckpt_min_gap = max(1, self.n // 16)
        self.ckpt_stats = dict.fromkeys(self.CKPT_COUNTERS, 0)
        self._ckpt_store: OrderedDict[tuple, tuple] = OrderedDict()
        self._seg_cache: dict[bytes, tuple[list[int], list[int]]] = {}

    def reset_checkpoints(self) -> None:
        """Drop stored snapshots and zero the hit/skip counters."""
        self._ckpt_store.clear()
        for k in self.ckpt_stats:
            self.ckpt_stats[k] = 0

    @property
    def checkpoint_hit_rate(self) -> float:
        """Fraction of record=False schedules resumed from a snapshot."""
        tot = self.ckpt_stats["resume_hits"] + self.ckpt_stats["cold_starts"]
        return self.ckpt_stats["resume_hits"] / tot if tot else 0.0

    def _segment_views(self, seg_layer: np.ndarray) -> tuple[list[int], list[int]]:
        """(per-CN segment ids, per-segment first layer) for one partition.

        Partitions repeat heavily across genomes (they depend only on which
        core each layer lands on relative to the weight capacities), so the
        expanded per-CN list is memoized by partition content."""
        key = seg_layer.tobytes()
        hit = self._seg_cache.get(key)
        if hit is None:
            seg_of = seg_layer[self._layer_arr].tolist()
            n_seg = int(seg_layer[-1]) + 1 if seg_layer.size else 1
            starts = np.searchsorted(seg_layer, np.arange(n_seg)).tolist()
            if len(self._seg_cache) >= 64:
                self._seg_cache.pop(next(iter(self._seg_cache)))
            hit = self._seg_cache[key] = (seg_of, starts)
        return hit

    def evaluate(self, allocation: Sequence[int], priority: str = "latency",
                 segment: bool = True, strict_layers: bool = False,
                 checkpoint: bool | None = None) -> tuple[float, float]:
        """(latency_cc, energy_pj) of one allocation — the GA fitness fast
        path: runs the timing model without trace recording, resuming from
        the deepest matching segment checkpoint."""
        res = self.schedule(allocation, priority, segment=segment,
                            strict_layers=strict_layers, record=False,
                            checkpoint=checkpoint)
        return (res.latency_cc, res.energy_pj)

    def evaluate_population(self, genomes, priority: str = "latency",
                            segment: bool = True, strict_layers: bool = False,
                            checkpoint: bool | None = None) -> np.ndarray:
        """Fitness of a whole (P, G) genome matrix -> (P, 2) [latency, energy].

        The population-batched entry point of the GA hot path: one row per
        genome, scheduled against the shared checkpoint store so genomes
        sharing allocation prefixes (parents and their offspring) replay
        only their differing suffixes."""
        genomes = np.asarray(genomes, dtype=np.int64)
        if genomes.ndim == 1:
            genomes = genomes[None, :]
        out = np.empty((genomes.shape[0], 2), dtype=np.float64)
        for r in range(genomes.shape[0]):
            res = self.schedule(genomes[r], priority, segment=segment,
                                strict_layers=strict_layers, record=False,
                                checkpoint=checkpoint)
            out[r, 0] = res.latency_cc
            out[r, 1] = res.energy_pj
        return out

    def schedule(self, allocation: Sequence[int], priority: str = "latency",
                 segment: bool = True, strict_layers: bool = False,
                 record: bool = True,
                 checkpoint: bool | None = None,
                 validate: bool = False) -> ScheduleResult:
        """Run the event loop for one layer-core allocation.

        `record=False` skips the observational traces (memory events, core/
        comm/DRAM intervals) — the memory *accounting* still runs, since
        overflow spills feed back into DRAM-port timing, so latency/energy
        are identical; `peak_mem_bytes`/`act_peak_bytes` come back as NaN.
        Use it for GA genome evaluations that only read latency/energy.

        `checkpoint` (record=False only; default = the engine's
        `checkpointing` flag) snapshots the loop state at every fused-stack
        barrier keyed by the allocation prefix, and resumes this schedule
        from the deepest stored snapshot whose prefix matches — the result
        is bit-identical to a cold run.

        `validate` (record=True only) runs the schedule race detector
        (`repro_torch.analysis.staticcheck.racecheck.validate_trace`) over the
        recorded trace before returning — use it when debugging new
        topologies or cost models; violations raise `TraceValidationError`
        naming the broken invariant.

            >>> from repro_torch.configs.paper_workloads import squeezenet
            >>> from repro_torch.core import CostModel, build_graph
            >>> from repro_torch.core.allocator import manual_pingpong
            >>> from repro_torch.hw.catalog import mc_hom_tpu
            >>> w, acc = squeezenet(), mc_hom_tpu()
            >>> graph = build_graph(w, acc, ("tile", 16, 1))
            >>> engine = ScheduleEngine(graph, CostModel(w, acc), acc)
            >>> alloc = manual_pingpong(w, acc)
            >>> res = engine.schedule(alloc, priority="latency")
            >>> res.latency_cc > 0 < res.energy_pj
            True
            >>> engine.evaluate(alloc) == (res.latency_cc, res.energy_pj)
            True
        """
        if priority not in ("latency", "memory"):
            raise ValueError(f"unknown priority {priority!r}")
        acc = self.accelerator
        n = self.n
        n_cores = acc.n_cores
        alloc = np.asarray(allocation, dtype=np.int64)
        alloc_l = alloc.tolist()
        if strict_layers:
            seg_of = self._layer_of          # seg id == layer id per CN
            seg_starts = self._strict_starts
            mode, incl = 2, 0                # cut at every layer: key excludes
        elif segment:                        # the entered segment's first gene
            seg_of_layer = _segments_from_arrays(alloc_l, self._layer_wb, self._w_cap)
            seg_of, seg_starts = self._segment_views(seg_of_layer)
            mode, incl = 1, 1                # cut placement depends on the
        else:                                # first gene: key includes it
            seg_of = self._zeros_n           # single fused stack
            seg_starts = [0]
            mode, incl = 0, 0
        core_of = alloc[self._layer_arr].tolist()

        # local bindings for the hot loop
        pred_zero, pred_data = self._pred_zero, self._pred_data
        succ_of = self._succ_of
        layer_of = self._layer_of
        out_bytes, weight_bytes = self._out_bytes, self._weight_bytes
        new_in_bytes, disc_bytes = self._new_in_bytes, self._disc_bytes
        cost_rows = self._cost_rows
        external_of = self._external_of
        w_cap, is_aimc, shared_l1 = self._w_cap, self._is_aimc, self._shared_l1
        routes, chan_bw, chan_e = self._routes, self._chan_bw, self._chan_e
        heappush, heappop = heapq.heappush, heapq.heappop
        heap_code = self._heap_code
        code_mask = self._code_mask
        by_memory = priority == "memory"

        # ---- checkpoint lookup: deepest stored prefix of this allocation ----
        use_ckpt = (not record) and self._ckpt_ok and (
            self.checkpointing if checkpoint is None else checkpoint)
        snap = None
        ab = b""
        store = self._ckpt_store
        pkey = (by_memory, mode)
        if use_ckpt:
            ab = alloc.tobytes()
            for s in range(len(seg_starts) - 1, 0, -1):
                key = (pkey, ab[: 8 * (seg_starts[s] + incl)])
                snap = store.get(key)
                if snap is not None:
                    store.move_to_end(key)
                    break

        act_cap = self._act_cap0
        if snap is None:
            if use_ckpt:
                self.ckpt_stats["cold_starts"] += 1
            core_free = [0.0] * n_cores
            core_busy = [0.0] * n_cores
            bus_free = 0.0
            chan_free = [0.0] * self._n_chan
            dram_free = 0.0
            finish = [0.0] * n
            act_used = [0.0] * n_cores
            resident: list[OrderedDict[int, int]] = [OrderedDict() for _ in range(n_cores)]
            resident_used = [0.0] * n_cores
            # fresh-byte bookkeeping: a producer CN's output is shipped to a
            # given core at most once (consumers on that core share the
            # data); keys are packed cn * n_cores + core — int-keyed dicts
            # hash faster and are invisible to the cyclic GC once snapshotted
            sent_to: dict[int, float] = {}       # cn/core -> arrival time
            remaining_new: dict[int, int] = {}   # cn -> bytes left to ship
            spilled: dict[int, float] = {}       # cn -> bytes pushed to DRAM
            have_spills = False
            e_compute = e_sram = e_bus = e_dram = 0.0
            comm_max = 0.0
            dram_max = 0.0
            seg_barrier: dict[int, float] = {0: 0.0}
            frontier = 0.0  # max finish over everything scheduled so far
            indeg = self._indeg0.copy()
            ready_key = [0.0] * n
            keysrc = self._neg_layer if by_memory else ready_key
            heap: list[tuple[int, float, int]] = []
            for i in range(n):
                if indeg[i] == 0:
                    heappush(heap, (seg_of[i], keysrc[i], heap_code[i]))
            scheduled = 0
            cur_seg = 0
        else:
            (k0, fin_p, indeg_s, rk_s, s_core_free, s_core_busy, s_act_used,
             s_res_used, s_resident, s_sent, s_rem, s_spill, have_spills,
             bus_free, dram_free, frontier, e_compute, e_sram, e_bus, e_dram,
             comm_max, dram_max, s_barrier, ready_ids, s_chan) = snap
            chan_free = list(s_chan)
            self.ckpt_stats["resume_hits"] += 1
            self.ckpt_stats["cns_skipped"] += k0
            core_free = list(s_core_free)
            core_busy = list(s_core_busy)
            act_used = list(s_act_used)
            resident_used = list(s_res_used)
            resident = [OrderedDict(r) for r in s_resident]
            sent_to = dict(s_sent)
            remaining_new = dict(s_rem)
            spilled = dict(s_spill)
            finish = list(fin_p) + [0.0] * (n - k0)
            indeg = [0] * k0 + list(indeg_s)
            ready_key = [0.0] * k0 + list(rk_s)
            keysrc = self._neg_layer if by_memory else ready_key
            seg_barrier = dict(s_barrier)
            scheduled = k0
            # rebuild the heap with this allocation's segment ids (the ready
            # set and its priority keys are prefix state; the seg ids of
            # not-yet-scheduled CNs are not, so they are recomputed here)
            heap = [(seg_of[v], keysrc[v], heap_code[v]) for v in ready_ids]
            heapq.heapify(heap)
            cur_seg = -1  # first pop re-enters the resumed segment's barrier

        # flat event buffers: (time, +/- bytes, core, kind-code)
        ev_t: list[float] = []
        ev_d: list[float] = []
        ev_c: list[int] = []
        ev_k: list[int] = []
        core_intervals: list[list[tuple[float, float, int]]] = [[] for _ in range(n_cores)]
        comm_intervals: list[tuple[float, float, int, int, int]] = []
        dram_intervals: list[tuple[float, float, str, int]] = []
        chan_intervals: list[tuple[float, float, int, int]] = []

        bus_bw = acc.bus_bw_bits_per_cc
        dram_bw = acc.dram_bw_bits_per_cc
        bus_e_bit = acc.bus_energy_pj_per_bit
        dram_e_bit = acc.dram_energy_pj_per_bit

        def dram_xfer(nbytes: float, kind: str, earliest: float = 0.0) -> float:
            """Schedule an off-chip access node; returns completion time."""
            nonlocal dram_free, e_dram, dram_max
            if nbytes <= 0:
                return earliest
            start = dram_free if dram_free > earliest else earliest
            dur = nbytes * 8.0 / dram_bw
            end = start + dur
            dram_free = end
            e_dram += nbytes * 8.0 * dram_e_bit
            if record:
                dram_intervals.append((start, end, kind, int(nbytes)))
            if end > dram_max:
                dram_max = end
            return end

        # ---- event loop -----------------------------------------------------
        # heap key: (segment, priority key, layer, intra rank, cn) — fused
        # stacks execute in order, so the segment id is the primary key. The
        # 'latency' priority key (max finish over predecessors) is maintained
        # incrementally by the successor loop instead of re-scanning preds.
        first_cn = self._first_cn_of_layer
        min_gap = self._ckpt_min_gap
        n_resumed = scheduled
        last_snap_k = scheduled   # resume point / run start counts as spaced
        cur_barrier = seg_barrier.get(cur_seg, 0.0)
        while heap:
            seg, _pk, code = heappop(heap)
            i = code & code_mask
            core = core_of[i]
            if seg != cur_seg:
                # segment barrier: every CN of previous segments is scheduled
                if use_ckpt and seg > 0:
                    lay0 = seg_starts[seg]
                    k0 = first_cn[lay0]
                    if k0 - last_snap_k >= min_gap:
                        last_snap_k = k0
                        key = (pkey, ab[: 8 * (lay0 + incl)])
                        if key not in store:
                            ready = [e[2] & code_mask for e in heap]
                            ready.append(i)
                            # tuples, not lists: scalar-only tuples (and
                            # scalar dicts) get *untracked* by the cyclic GC,
                            # so a full snapshot store does not make every
                            # collection traverse thousands of containers
                            store[key] = (
                                k0, tuple(finish[:k0]), tuple(indeg[k0:]),
                                tuple(ready_key[k0:]), tuple(core_free),
                                tuple(core_busy), tuple(act_used),
                                tuple(resident_used),
                                tuple(dict(r) for r in resident),
                                dict(sent_to), dict(remaining_new),
                                dict(spilled), have_spills, bus_free,
                                dram_free, frontier, e_compute, e_sram, e_bus,
                                e_dram, comm_max, dram_max, dict(seg_barrier),
                                tuple(ready), tuple(chan_free))
                            self.ckpt_stats["snapshots"] += 1
                            if len(store) > self.ckpt_capacity:
                                store.popitem(last=False)
                cur_seg = seg
                cur_barrier = seg_barrier.get(seg)
                if cur_barrier is None:
                    cur_barrier = seg_barrier[seg] = frontier  # prev stack done
            cost = cost_rows[i][core]
            if cost is None:
                raise ValueError(
                    f"CN of layer {layer_of[i]} allocated to incompatible core {core}")
            cyc, e_cn_comp, e_cn_sram = cost

            # ---- incoming data: communication + spill readback --------------
            # ordering-only predecessors: just a finish max (no bus, and no
            # spill share either — a zero-byte edge reads back zero bytes)
            data_ready = 0.0
            for u in pred_zero[i]:
                fu = finish[u]
                if fu > data_ready:
                    data_ready = fu
            for u, e_bytes in pred_data[i]:
                if shared_l1 or (u_core := core_of[u]) == core:
                    # same core or shared-L1 architecture (DIANA-style):
                    # both cores address one copy, no transfer node
                    fu = finish[u]
                    if fu > data_ready:
                        data_ready = fu
                else:
                    skey = u * n_cores + core
                    arrived = sent_to.get(skey)
                    if arrived is not None:
                        if arrived > data_ready:
                            data_ready = arrived
                    else:
                        rem = remaining_new.get(u)
                        if rem is None:
                            rem = out_bytes[u]
                        fresh = e_bytes if e_bytes < rem else rem
                        remaining_new[u] = rem - fresh
                        fu = finish[u]
                        if routes is None:
                            start = bus_free if bus_free > fu else fu
                            dur = fresh * 8.0 / bus_bw
                            end = start + dur
                            bus_free = end
                            e_bus += fresh * 8.0 * bus_e_bit
                        else:
                            # multi-hop transfer: occupy each channel of the
                            # route in order (store-and-forward), FCFS per
                            # channel; a single-cluster route is one local-
                            # bus hop with the flat-bus arithmetic exactly
                            end = fu
                            start = fu
                            first = True
                            for ch in routes[u_core][core]:
                                s = chan_free[ch]
                                if s < end:
                                    s = end
                                if first:
                                    start = s
                                    first = False
                                end = s + fresh * 8.0 / chan_bw[ch]
                                chan_free[ch] = end
                                e_bus += fresh * 8.0 * chan_e[ch]
                                if record:
                                    chan_intervals.append(
                                        (s, end, ch, int(fresh)))
                        if record:
                            comm_intervals.append((start, end, u, i, int(fresh)))
                        if end > comm_max:
                            comm_max = end
                        # consumer allocates at comm start; producer frees at
                        # end (inlined; the comm path implies not shared_l1)
                        if fresh > 0:
                            cfree = act_cap[core] - act_used[core]
                            clamped = cfree if cfree > 0.0 else 0.0
                            kept = fresh if fresh <= clamped else clamped
                            act_used[core] += kept
                            if record:
                                ev_t.append(start); ev_d.append(kept)
                                ev_c.append(core); ev_k.append(_KIND_ACT)
                            overflow = fresh - kept
                            if overflow > 0:
                                spilled[u] = spilled.get(u, 0.0) + overflow
                                have_spills = True
                                dram_xfer(overflow, "spill_w", start)
                            used_u = act_used[u_core]
                            rel = fresh if fresh <= used_u else used_u
                            act_used[u_core] = used_u - rel
                            if record:
                                ev_t.append(end); ev_d.append(-rel)
                                ev_c.append(u_core); ev_k.append(_KIND_ACT)
                        sent_to[skey] = end
                        if end > data_ready:
                            data_ready = end
                # spilled producer data must be read back through the DRAM port
                if have_spills:
                    sp = spilled.get(u)
                    if sp:
                        share = sp if sp < e_bytes else e_bytes
                        done = dram_xfer(share, "spill_r", finish[u])
                        if done > data_ready:
                            data_ready = done

            # ---- first-layer external inputs fetched via DRAM port ----------
            # just-in-time prefetch: no earlier than needed for the core
            # frontier, so inputs do not pile up on chip (staged fetch)
            if external_of[i]:
                nbytes = new_in_bytes[i]
                dur = nbytes * 8.0 / dram_bw
                earliest = core_free[core] - dur * PREFETCH_DEPTH
                done = dram_xfer(nbytes, "input", earliest if earliest > 0.0 else 0.0)
                if nbytes > 0:
                    mcore = 0 if shared_l1 else core
                    ifree = act_cap[mcore] - act_used[mcore]
                    clamped = ifree if ifree > 0.0 else 0.0
                    kept = nbytes if nbytes <= clamped else clamped
                    act_used[mcore] += kept
                    if record:
                        ev_t.append(done); ev_d.append(kept)
                        ev_c.append(mcore); ev_k.append(_KIND_ACT)
                    overflow = nbytes - kept
                    if overflow > 0:
                        spilled[i] = spilled.get(i, 0.0) + overflow
                        have_spills = True
                        dram_xfer(overflow, "spill_w", done)
                if done > data_ready:
                    data_ready = done

            # ---- weights: on-core residency with FIFO eviction --------------
            # Oversized layers (weights > weight memory) stream double-buffered
            # and occupy the full buffer while the core keeps processing that
            # layer; the full fetch cost recurs only when residency is lost
            # (interleaving with another weight-hungry layer = thrashing).
            weight_ready = 0.0
            wb = weight_bytes[i]
            if wb > 0:
                cap = w_cap[core]
                lid = layer_of[i]
                res = resident[core]
                if lid not in res:
                    if cap > 0:
                        hold = wb if wb < cap else cap
                    else:
                        hold = 0
                    evicted_bytes = 0
                    while resident_used[core] + hold > cap and res:
                        _, evicted = res.popitem(last=False)  # FIFO
                        resident_used[core] -= evicted
                        evicted_bytes += evicted
                    res[lid] = hold
                    resident_used[core] += hold
                    # inlined dram_xfer (earliest=0: the port is never idle
                    # backwards) — the hottest off-chip access site
                    d_start = dram_free
                    weight_ready = dram_free = d_start + wb * 8.0 / dram_bw
                    e_dram += wb * 8.0 * dram_e_bit
                    if weight_ready > dram_max:
                        dram_max = weight_ready
                    if record:
                        kind = "weight" if wb <= cap else "weight_stream"
                        dram_intervals.append(
                            (d_start, weight_ready, kind, int(wb)))
                        # weights occupy on-chip SRAM (AiMC weights in-array)
                        if not is_aimc[core] and hold > 0:
                            ev_t.append(weight_ready); ev_d.append(float(hold))
                            ev_c.append(core); ev_k.append(_KIND_WEIGHT)
                            if evicted_bytes:
                                ev_t.append(weight_ready)
                                ev_d.append(-float(evicted_bytes))
                                ev_c.append(core); ev_k.append(_KIND_WEIGHT)

            # ---- execute ----------------------------------------------------
            start = core_free[core]
            if data_ready > start:
                start = data_ready
            if weight_ready > start:
                start = weight_ready
            if cur_barrier > start:
                start = cur_barrier
            end = start + cyc
            core_free[core] = end
            core_busy[core] += cyc
            finish[i] = end
            if end > frontier:
                frontier = end
            if record:
                core_intervals[core].append((start, end, i))
            e_compute += e_cn_comp
            e_sram += e_cn_sram

            # memory trace: outputs allocated at start, exclusive inputs freed
            # at end (inlined alloc_act/free_act: the two always-taken sites)
            nb = out_bytes[i]
            if nb > 0:
                mcore = 0 if shared_l1 else core
                free = act_cap[mcore] - act_used[mcore]
                clamped = free if free > 0.0 else 0.0
                kept = nb if nb <= clamped else clamped
                act_used[mcore] += kept
                if record:
                    ev_t.append(start); ev_d.append(kept)
                    ev_c.append(mcore); ev_k.append(_KIND_ACT)
                overflow = nb - kept
                if overflow > 0:
                    spilled[i] = spilled.get(i, 0.0) + overflow
                    have_spills = True
                    dram_xfer(overflow, "spill_w", start)
            nb = disc_bytes[i]
            if nb > 0:
                mcore = 0 if shared_l1 else core
                used = act_used[mcore]
                rel = nb if nb <= used else used
                act_used[mcore] = used - rel
                if record:
                    ev_t.append(end); ev_d.append(-rel)
                    ev_c.append(mcore); ev_k.append(_KIND_ACT)

            scheduled += 1
            for v in succ_of[i]:
                if end > ready_key[v]:
                    ready_key[v] = end
                d = indeg[v] - 1
                indeg[v] = d
                if d == 0:
                    heappush(heap, (seg_of[v], keysrc[v], heap_code[v]))

        if scheduled != n:
            raise RuntimeError(f"scheduled {scheduled}/{n} CNs: dependency cycle?")
        if use_ckpt:
            self.ckpt_stats["cns_scheduled"] += n - n_resumed

        latency = max(frontier if n else 0.0, comm_max, dram_max)
        energy = {"compute": e_compute, "sram": e_sram, "bus": e_bus, "dram": e_dram}
        total_e = e_compute + e_sram + e_bus + e_dram

        # ---- Step 5.2: activation memory usage trace (vectorized) ----------
        if record:
            peak, act_peak = _peaks_from_buffers(ev_t, ev_d, ev_k)
        else:
            peak = act_peak = float("nan")

        result = ScheduleResult(
            latency_cc=float(latency),
            energy_pj=float(total_e),
            energy_breakdown=energy,
            peak_mem_bytes=peak,
            act_peak_bytes=act_peak,
            core_intervals=core_intervals,
            comm_intervals=comm_intervals,
            dram_intervals=dram_intervals,
            core_busy=np.array(core_busy),
            mem_buffers=(ev_t, ev_d, ev_c, ev_k),
            chan_intervals=chan_intervals,
        )
        tracer = self.tracer
        if tracer is not None:
            # sim-time channel: counters/histograms only (bounded memory per
            # GA run); the tracer observes, it never steers the schedule.
            tracer.count("engine.schedules")
            tracer.count("engine.cns", n)
            tracer.observe("engine.latency_cc", result.latency_cc)
            tracer.observe("engine.energy_pj", result.energy_pj)
        if validate:
            if not record:
                raise ValueError("validate=True needs record=True "
                                 "(the detector consumes the trace)")
            from repro_torch.analysis.staticcheck.racecheck import \
                validate_trace
            validate_trace(result, self.graph, acc,
                           workload=self.cost_model.workload,
                           segment=segment, strict_layers=strict_layers)
        return result


def _peaks_from_buffers(ev_t: list[float], ev_d: list[float],
                        ev_k: list[int]) -> tuple[float, float]:
    """Peak of the cumulative +/- byte trace, total and activations-only.

    Equivalent to `memtrace.peak_memory` on the tuple list: stable sort by
    time (ties keep insertion order) then a running float64 sum — np.cumsum
    accumulates sequentially, so the partial sums match the Python loop
    bit-for-bit.
    """
    if not ev_t:
        return 0.0, 0.0
    t = np.array(ev_t)
    d = np.array(ev_d)
    k = np.array(ev_k, dtype=np.int8)
    order = np.argsort(t, kind="stable")
    d_sorted = d[order]
    run = np.cumsum(d_sorted)
    peak = max(float(run.max()), 0.0)
    act_d = d_sorted[k[order] == _KIND_ACT]
    if act_d.size:
        act_peak = max(float(np.cumsum(act_d).max()), 0.0)
    else:
        act_peak = 0.0
    return peak, act_peak


_ENGINES_PER_GRAPH = 8


def get_engine(graph: CNGraph, cost_model: CostModel,
               accelerator: Accelerator) -> ScheduleEngine:
    """Engine for (graph, cost_model, accelerator), cached on the graph.

    Keyed on content — the accelerator (hashable frozen dataclass), the cost
    function, and the workload's `cache_key()` — so independently constructed
    but equivalent CostModels (e.g. one per `evaluate_allocation` call, or a
    `from_dict` round-trip of the same workload) share one precomputed engine
    instead of each paying the table build."""
    cache = getattr(graph, "_engine_cache", None)
    if cache is None:
        cache = graph._engine_cache = {}
    key = (accelerator, cost_model.cost_fn, cost_model.workload.cache_key())
    engine = cache.get(key)
    if engine is None:
        if len(cache) >= _ENGINES_PER_GRAPH:
            cache.pop(next(iter(cache)))
        engine = cache[key] = ScheduleEngine(graph, cost_model, accelerator)
    return engine


def schedule(
    graph: CNGraph,
    cost_model: CostModel,
    allocation: Sequence[int],        # layer id -> core id
    accelerator: Accelerator,
    priority: str = "latency",
    segment: bool = True,             # fused-stack segmentation (see above)
    strict_layers: bool = False,      # traditional LBL: barrier after every layer
    validate: bool = False,           # run the race detector over the trace
) -> ScheduleResult:
    """Seed-compatible entry point: array-native engine, cached per graph."""
    engine = get_engine(graph, cost_model, accelerator)
    return engine.schedule(allocation, priority, segment=segment,
                           strict_layers=strict_layers, validate=validate)


def schedule_reference(
    graph: CNGraph,
    cost_model: CostModel,
    allocation: Sequence[int],
    accelerator: Accelerator,
    priority: str = "latency",
    segment: bool = True,
    strict_layers: bool = False,
) -> ScheduleResult:
    """The seed object/dict implementation, kept as the golden oracle for
    `ScheduleEngine` equivalence tests (identical semantics, ~10x slower)."""
    cns = graph.cns
    n = len(cns)
    alloc = np.asarray(allocation, dtype=np.int64)
    core_of = np.array([alloc[cn.layer] for cn in cns], dtype=np.int64)
    if strict_layers:
        seg_of_layer = np.arange(len(cost_model.workload.layers), dtype=np.int64)
    elif segment:
        seg_of_layer = compute_segments(cost_model.workload, alloc, accelerator)
    else:
        seg_of_layer = np.zeros(len(cost_model.workload.layers), dtype=np.int64)
    seg_of = seg_of_layer[[cn.layer for cn in cns]]
    seg_barrier: dict[int, float] = {0: 0.0}
    frontier = 0.0  # max finish time over everything scheduled so far

    core_free = np.zeros(accelerator.n_cores)
    core_busy = np.zeros(accelerator.n_cores)
    bus_free = 0.0
    dram_free = 0.0
    finish = np.zeros(n)

    # cluster topology: channel resources replacing the one shared bus
    if accelerator.topology is not None and accelerator.comm_style != "shared_mem":
        from repro_torch.hw.topology import build_channels
        chan_bw, chan_e, topo_routes = build_channels(accelerator)
        chan_free = [0.0] * len(chan_bw)
    else:
        chan_bw = chan_e = topo_routes = None
        chan_free = []

    # per-core memory state; shared-L1 architectures pool all activation
    # capacity into one space (index 0) that every core addresses
    shared_l1 = accelerator.comm_style == "shared_mem"
    if shared_l1:
        act_cap = np.zeros(accelerator.n_cores)
        act_cap[0] = sum(c.act_mem_bytes for c in accelerator.cores)
    else:
        act_cap = np.array([c.act_mem_bytes for c in accelerator.cores], dtype=np.float64)
    act_used = np.zeros(accelerator.n_cores)
    w_cap = [c.weight_mem_bytes for c in accelerator.cores]
    resident: list[OrderedDict[int, int]] = [OrderedDict() for _ in accelerator.cores]
    resident_used = np.zeros(accelerator.n_cores)

    # fresh-byte bookkeeping: a producer CN's output is shipped to a given core
    # at most once (consumers on that core share the landed data)
    sent_to: dict[tuple[int, int], float] = {}  # (cn, core) -> arrival time
    remaining_new: dict[int, int] = {}          # cn -> bytes left to ship
    spilled: dict[int, float] = {}              # cn -> bytes pushed to DRAM

    energy = {"compute": 0.0, "sram": 0.0, "bus": 0.0, "dram": 0.0}
    mem_events: list[tuple[float, float, int, str]] = []
    core_intervals: list[list[tuple[float, float, int]]] = [[] for _ in accelerator.cores]
    comm_intervals: list[tuple[float, float, int, int, int]] = []
    dram_intervals: list[tuple[float, float, str, int]] = []
    chan_intervals: list[tuple[float, float, int, int]] = []

    bus_bw = accelerator.bus_bw_bits_per_cc
    dram_bw = accelerator.dram_bw_bits_per_cc

    def dram_xfer(nbytes: float, kind: str, earliest: float = 0.0) -> float:
        """Schedule an off-chip access node; returns completion time."""
        nonlocal dram_free
        if nbytes <= 0:
            return earliest
        start = max(dram_free, earliest)
        dur = nbytes * 8.0 / dram_bw
        dram_free = start + dur
        energy["dram"] += nbytes * 8.0 * accelerator.dram_energy_pj_per_bit
        dram_intervals.append((start, start + dur, kind, int(nbytes)))
        return start + dur

    def alloc_act(core: int, nbytes: float, t: float, producer_cn: int) -> None:
        """Allocate activation bytes on a core; overflow spills to DRAM."""
        if nbytes <= 0:
            return
        if shared_l1:
            core = 0
        free = act_cap[core] - act_used[core]
        kept = min(nbytes, max(free, 0.0))
        overflow = nbytes - kept
        act_used[core] += kept
        mem_events.append((t, kept, core, "act"))
        if overflow > 0:
            spilled[producer_cn] = spilled.get(producer_cn, 0.0) + overflow
            dram_xfer(overflow, "spill_w", t)

    def free_act(core: int, nbytes: float, t: float) -> None:
        if nbytes <= 0:
            return
        if shared_l1:
            core = 0
        rel = min(nbytes, act_used[core])
        act_used[core] -= rel
        mem_events.append((t, -rel, core, "act"))

    # ---- candidate pool -----------------------------------------------------
    indeg = np.array([len(p) for p in graph.preds], dtype=np.int64)
    heap: list[tuple[int, float, int, int, int]] = []

    def push(i: int) -> None:
        cn = cns[i]
        if priority == "latency":
            key = max((finish[u] for u in graph.preds[i]), default=0.0)
        elif priority == "memory":
            key = -float(cn.layer)
        else:
            raise ValueError(f"unknown priority {priority!r}")
        # fused stacks execute in order: segment id is the primary key
        heapq.heappush(heap, (int(seg_of[i]), key, cn.layer, cn.intra_rank, i))

    for i in range(n):
        if indeg[i] == 0:
            push(i)

    scheduled = 0
    while heap:
        _, _, _, _, i = heapq.heappop(heap)
        cn = cns[i]
        core = int(core_of[i])
        seg = int(seg_of[i])
        if seg not in seg_barrier:
            seg_barrier[seg] = frontier  # stack barrier: previous stack done
        cost = cost_model.cost(cn, core)
        if cost is None:
            raise ValueError(
                f"CN of layer {cn.layer} allocated to incompatible core {core}")

        # ---- incoming data: communication + spill readback ----------------
        data_ready = 0.0
        for u in graph.preds[i]:
            e_bytes = graph.edge_bytes[(u, i)]
            u_core = int(core_of[u])
            if u_core == core or e_bytes == 0 or accelerator.comm_style == "shared_mem":
                # same core, pure ordering edge, or shared-L1 architecture
                # (DIANA-style): both cores address one copy, no transfer node
                data_ready = max(data_ready, finish[u])
            else:
                key = (u, core)
                if key in sent_to:
                    data_ready = max(data_ready, sent_to[key])
                else:
                    rem = remaining_new.get(u)
                    if rem is None:
                        rem = cns[u].out_bytes
                    fresh = min(e_bytes, rem)
                    remaining_new[u] = rem - fresh
                    if topo_routes is None:
                        start = max(bus_free, finish[u])
                        dur = fresh * 8.0 / bus_bw
                        bus_free = start + dur
                        energy["bus"] += fresh * 8.0 * accelerator.bus_energy_pj_per_bit
                        end_t = start + dur
                    else:
                        # multi-hop: store-and-forward over the route's
                        # channels, FCFS on each (see ScheduleEngine)
                        end_t = start = finish[u]
                        first = True
                        for ch in topo_routes[u_core][core]:
                            s = max(chan_free[ch], end_t)
                            if first:
                                start, first = s, False
                            end_t = s + fresh * 8.0 / chan_bw[ch]
                            chan_free[ch] = end_t
                            energy["bus"] += fresh * 8.0 * chan_e[ch]
                            chan_intervals.append((s, end_t, ch, int(fresh)))
                    comm_intervals.append((start, end_t, u, i, int(fresh)))
                    # consumer allocates at comm start; producer frees at comm end
                    alloc_act(core, fresh, start, u)
                    free_act(u_core, fresh, end_t)
                    sent_to[key] = end_t
                    data_ready = max(data_ready, end_t)
            # spilled producer data must be read back through the DRAM port
            sp = spilled.get(u, 0.0)
            if sp > 0:
                share = min(sp, e_bytes)
                data_ready = max(data_ready, dram_xfer(share, "spill_r", finish[u]))

        # ---- first-layer external inputs fetched via DRAM port -------------
        # just-in-time prefetch: no earlier than needed for the core frontier,
        # so inputs do not pile up in on-chip memory (double-buffered fetch)
        layer = cost_model.workload.layers[cn.layer]
        if not layer.inputs:
            nbytes = cn.new_inputs * cn.in_bits / 8.0
            dur = nbytes * 8.0 / dram_bw
            done = dram_xfer(nbytes, "input", max(0.0, core_free[core] - dur * PREFETCH_DEPTH))
            alloc_act(core, nbytes, done, i)
            data_ready = max(data_ready, done)

        # ---- weights: on-core residency with FIFO eviction ------------------
        # Oversized layers (weights > weight memory) stream double-buffered and
        # occupy the full buffer while the core keeps processing that layer;
        # the full fetch cost recurs only when residency is lost (interleaving
        # with another weight-hungry layer on the same core = thrashing).
        weight_ready = 0.0
        wb = cn.weight_bytes
        if wb > 0:
            hold = min(wb, w_cap[core]) if w_cap[core] > 0 else 0
            if cn.layer not in resident[core]:
                evicted_bytes = 0
                while resident_used[core] + hold > w_cap[core] and resident[core]:
                    _, evicted = resident[core].popitem(last=False)  # FIFO
                    resident_used[core] -= evicted
                    evicted_bytes += evicted
                resident[core][cn.layer] = hold
                resident_used[core] += hold
                kind = "weight" if wb <= w_cap[core] else "weight_stream"
                weight_ready = dram_xfer(wb, kind, 0.0)
                # weights occupy on-chip SRAM (AiMC weights live in the array)
                if accelerator.cores[core].core_type != "aimc" and hold > 0:
                    mem_events.append((weight_ready, float(hold), core, "weight"))
                    if evicted_bytes:
                        mem_events.append((weight_ready, -float(evicted_bytes), core, "weight"))

        # ---- execute --------------------------------------------------------
        start = max(core_free[core], data_ready, weight_ready, seg_barrier[seg])
        end = start + cost.cycles
        core_free[core] = end
        core_busy[core] += cost.cycles
        finish[i] = end
        frontier = max(frontier, end)
        core_intervals[core].append((start, end, i))
        energy["compute"] += cost.breakdown["compute"]
        energy["sram"] += (cost.breakdown["sram_act"] + cost.breakdown["sram_w"])

        # memory trace: outputs allocated at start, exclusive inputs freed at end
        alloc_act(core, cn.out_bytes, start, i)
        free_act(core, cn.discardable_inputs * cn.in_bits / 8.0, end)

        scheduled += 1
        for v in graph.succs[i]:
            indeg[v] -= 1
            if indeg[v] == 0:
                push(v)

    if scheduled != n:
        raise RuntimeError(f"scheduled {scheduled}/{n} CNs: dependency cycle?")

    latency = float(max(
        finish.max() if n else 0.0,
        max((e for _, e, *_ in comm_intervals), default=0.0),
        max((e for _, e, *_ in dram_intervals), default=0.0),
    ))
    total_e = float(sum(energy.values()))

    # ---- Step 5.2: activation memory usage trace ----------------------------
    from repro_torch.core.memtrace import peak_memory
    peak = peak_memory(mem_events)
    act_peak = peak_memory(mem_events, kind="act")

    return ScheduleResult(
        latency_cc=latency,
        energy_pj=total_e,
        energy_breakdown=dict(energy),
        peak_mem_bytes=peak,
        act_peak_bytes=act_peak,
        core_intervals=core_intervals,
        comm_intervals=comm_intervals,
        dram_intervals=dram_intervals,
        core_busy=core_busy,
        mem_events=mem_events,
        chan_intervals=chan_intervals,
    )
