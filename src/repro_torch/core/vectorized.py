"""Batched approximate schedule fitness: the PyTorch population path.

`ScheduleEngine.evaluate_population` walks a Python event loop one CN at a
time per genome — exact, but the throughput ceiling of every GA sweep.
`BatchedFitness` evaluates a whole `(P, G)` population at once as tensor
code on one device (the port of the JAX package's `repro/core/vectorized.py`):

* the CSR `CNGraph` is *wavefront-levelized* (CNs grouped by longest-path
  depth, members in CN-id order — a topological order by construction);
* everything that depends on the genome but not on time is hoisted into
  per-wavefront tensors, population last (`(L, W, P)`); then a scan over
  wavefronts computes every member's ready time from predecessor finishes,
  channel transfers, DRAM weight/input fetches and fused-stack barriers
  (`repro_torch.kernels.ref.wavefront_scan_ref`);
* FCFS contention (cores, bus/link channels, the DRAM port) is
  approximated as per-resource *prefix serialization* within the wavefront:
  the queue recurrence ``f_k = max(f_{k-1}, r_k) + d_k`` unrolls into
  cumsum/cummax prefix ops (`repro_torch.kernels.ref.serialize_prefix_ref`);
* on CUDA the whole scan of a chunk of genomes is one launch of a
  hand-written kernel (`repro_torch.kernels.wavefront.wavefront_scan`, the
  "fused" route); a graph too wide for it runs the scan as a loop with a
  `serialize_prefix` kernel per queue update (the "step" route, see
  `repro_torch.kernels.wavefront.scan_route`).

The result is a *fitness approximation*: global heap order collapses to
wavefront order, fresh-byte dedup and spill feedback are dropped, weights
are fetched once per layer, and external inputs lose their just-in-time
staging. Scores therefore only *rank* genomes — `GeneticAllocator` uses
them as a prefilter that prunes each offspring batch to plausible NSGA-II
survivors, which the exact engine re-scores (`rescore`), keeping every
stored metric bit-identical. `latency_lower_bound` is the provable
counterpart (no-contention critical path, per-core work, mandatory DRAM
traffic): it never exceeds the exact latency beyond float rounding.

Every tensor is float32, as in the reference. `device=None` means CUDA; a
machine without CUDA raises rather than falling back to the CPU.

    >>> import numpy as np
    >>> round(rank_correlation(np.array([1.0, 2.0, 3.0, 4.0]),
    ...                        np.array([10.0, 20.0, 30.0, 40.0])), 6)
    1.0
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.ref import (population_last, serialize_prefix_ref,
                                     wavefront_scan_ref)
from repro_torch.kernels.wavefront import (scan_route, serialize_prefix,
                                           wavefront_scan)

BIG = 1e30      # cycles stand-in for infeasible (CN, core) pairs
NEG = -1e30     # release-time stand-in for "not queued on this resource"

_OBJECTIVES = ("edp", "latency", "energy")


def resolve_device(device=None) -> torch.device:
    """`None` -> CUDA.  Raises when the named device is CUDA and CUDA is
    absent: the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def rank_correlation(a, b) -> float:
    """Spearman rank correlation of two score vectors (ordinal ranks).

    The prefilter contract is *ranking*, so this — not absolute error — is
    the figure of merit comparing approximate and exact fitness.

        >>> rank_correlation([3.0, 1.0, 2.0], [30.0, 10.0, 20.0])
        1.0
        >>> rank_correlation([1.0, 2.0], [2.0, 1.0])
        -1.0
    """
    a = np.asarray(a, dtype=float).ravel()
    b = np.asarray(b, dtype=float).ravel()
    if a.size != b.size or a.size < 2:
        raise ValueError("need two equal-length vectors of >= 2 scores")
    ra = np.empty(a.size)
    rb = np.empty(b.size)
    ra[np.argsort(a, kind="stable")] = np.arange(a.size)
    rb[np.argsort(b, kind="stable")] = np.arange(b.size)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = math.sqrt(float(np.dot(ra, ra)) * float(np.dot(rb, rb)))
    return float(np.dot(ra, rb) / denom) if denom else 0.0


def _pow2_at_least(k: int) -> int:
    return 1 << max(k - 1, 1).bit_length() if k > 1 else 1


class BatchedFitness:
    """Vectorized approximate (latency, energy) for genome populations.

    Binds one `ScheduleEngine` (graph + cost tables + accelerator
    constants) and moves its wavefront tables to `device`.  `scores`
    approximates, `rescore` delegates to the exact engine, and `prefilter`
    packages the scalarized approximate score for
    `GeneticAllocator(prefilter=...)`.

    `use_kernel=True` scores "serialize" contention through the CUDA
    kernels' wrappers (which run the kernels on CUDA tensors and the plain
    versions on CPU ones); `False` runs the plain PyTorch loop directly — on
    CUDA that exists only to hold the kernels against it.  `contention=None`
    is "serialize" on CUDA and "backlog" on the CPU; the backlog model has
    no kernel and always runs the plain loop.

    `route` says how a chunk is scored: "fused" (one `wavefront_scan`
    launch runs the whole scan over wavefronts), "step" (a loop over
    wavefronts with a `serialize_prefix` launch per queue update) or
    "plain" (the loop in plain PyTorch).  `kernel=None` lets `scan_route`
    choose between the first two from the graph's shapes; "fused" or
    "step" names the route (a graph that `scan_route` sends to "step"
    cannot take "fused").
    """

    def __init__(self, engine, priority: str = "latency",
                 segment: bool = True, strict_layers: bool = False,
                 use_kernel: bool = True,
                 contention: str | None = None, model_spills: bool = True,
                 max_batch: int = 256, device=None,
                 kernel: str | None = None):
        if priority not in ("latency", "memory"):
            raise ValueError(f"unknown priority {priority!r}")
        self.device = resolve_device(device)
        self.engine = engine
        self.priority = priority
        self.segment = segment
        self.strict_layers = strict_layers
        self.max_batch = int(max_batch)
        on_cuda = self.device.type == "cuda"
        self.use_kernel = bool(use_kernel)
        # per-resource queue model: "serialize" is the full intra-wavefront
        # prefix serialization (the CUDA kernel's job); "backlog" is its
        # saturated-queue specialization (`f_i = max(r_i, free) + d_i`,
        # `free += sum(d)` — exact whenever the resource never idles inside
        # a wavefront), the better throughput/fidelity point on the CPU
        if contention is None:
            contention = "serialize" if on_cuda else "backlog"
        if contention not in ("serialize", "backlog"):
            raise ValueError(f"unknown contention model {contention!r}")
        self.contention = contention
        self.model_spills = bool(model_spills)
        self.segment_mode = ("strict" if strict_layers
                             else "greedy" if segment else "none")
        if on_cuda:
            # the one matrix product (per-level byte sums) stays full float32
            torch.backends.cuda.matmul.allow_tf32 = False
        self._build_static()
        self._serialize_t = population_last(
            serialize_prefix if self.use_kernel else serialize_prefix_ref)
        kernels = self.use_kernel and contention == "serialize"
        if kernel not in (None, "fused", "step"):
            raise ValueError(f"unknown kernel {kernel!r}")
        if kernel is not None and not kernels:
            raise ValueError(f"kernel={kernel!r} needs use_kernel=True and "
                             f"serialize contention")
        rule = scan_route(self.n, self.width, self.n_cores, self.n_chan,
                          self.n_layers, self.dmax)
        if (kernel, rule) == ("fused", "step"):
            raise ValueError(f"width {self.width} or {self.n} CNs take the "
                             f"step route")
        self.route = (kernel or rule) if kernels else "plain"

    # ---- static precompute (numpy, once per engine binding) ---------------
    def _build_static(self) -> None:
        eng = self.engine
        graph = eng.graph
        acc = eng.accelerator
        n = graph.n
        n_cores = acc.n_cores
        self.n, self.n_cores = n, n_cores
        self.n_layers = eng.n_layers

        indptr = graph.pred_indptr
        idx = graph.pred_indices
        byt = graph.pred_bytes
        cons = np.repeat(np.arange(n), np.diff(indptr))
        if idx.size and not bool(np.all(idx < cons)):
            raise ValueError("CN ids are not a topological order")

        # longest-path levels -> wavefronts (members kept in CN-id order)
        level = np.zeros(n, dtype=np.int64)
        ptr = indptr.tolist()
        preds = [idx[ptr[v]:ptr[v + 1]] for v in range(n)]
        for v in range(n):
            if preds[v].size:
                level[v] = int(level[preds[v]].max()) + 1
        n_levels = int(level.max()) + 1 if n else 1
        counts = np.bincount(level, minlength=n_levels)
        width = int(counts.max()) if n else 1
        wf = np.full((n_levels, width), n, dtype=np.int32)
        slot = np.zeros(n_levels, dtype=np.int64)
        for v in range(n):  # id order per level == FCFS service order
            lv = level[v]
            wf[lv, slot[lv]] = v
            slot[lv] += 1
        self.n_wavefronts, self.width = n_levels, width

        dmax = int(np.diff(indptr).max()) if n and idx.size else 0
        pred_ids = np.full((n + 1, dmax), n, dtype=np.int32)
        pred_b = np.zeros((n + 1, dmax), dtype=np.float32)
        for v in range(n):
            k = ptr[v + 1] - ptr[v]
            if k:
                pred_ids[v, :k] = idx[ptr[v]:ptr[v + 1]]
                pred_b[v, :k] = byt[ptr[v]:ptr[v + 1]]
        self.dmax = dmax
        # per-wavefront static view (gathered once here instead of per
        # loop step): predecessor slots
        wf_pred = pred_ids[wf] if dmax else np.zeros(
            (n_levels, width, 1), dtype=np.int32)

        # successor lists (producer-side view of the same edges) + the map
        # from pred slot (v, d) to the producer's succ slot — fresh-byte
        # dedup is defined over each producer's consumers in id order
        sptr = graph.succ_indptr.tolist()
        sidx = graph.succ_indices
        sbyt = graph.succ_bytes
        smax = int(np.diff(graph.succ_indptr).max()) if n and sidx.size else 0
        succ_ids = np.full((n + 1, max(smax, 1)), n, dtype=np.int32)
        succ_b = np.zeros((n + 1, max(smax, 1)), dtype=np.float32)
        slot_of = {}
        for u in range(n):
            k = sptr[u + 1] - sptr[u]
            for s in range(k):
                v = int(sidx[sptr[u] + s])
                succ_ids[u, s] = v
                succ_b[u, s] = sbyt[sptr[u] + s]
                slot_of[(u, v)] = s
        edge_slot = np.zeros((n + 1, dmax), dtype=np.int32)
        for v in range(n):
            for d in range(ptr[v + 1] - ptr[v]):
                edge_slot[v, d] = slot_of[(int(idx[ptr[v] + d]), v)]
        self.smax = max(smax, 1)

        tab = eng.tables
        feas = tab.feasible.astype(bool)
        cyc = np.where(feas, tab.cycles, BIG).astype(np.float32)
        ecs = np.where(feas, tab.e_compute + tab.e_sram, BIG).astype(np.float32)
        sig = tab.sig_of_cn
        cyc_nc = np.zeros((n + 1, n_cores), dtype=np.float32)
        ecs_nc = np.zeros((n + 1, n_cores), dtype=np.float32)
        cyc_nc[:n] = cyc[sig]
        ecs_nc[:n] = ecs[sig]

        layer_pad = np.zeros(n + 1, dtype=np.int32)
        layer_pad[:n] = graph.layer
        head = np.zeros(n + 1, dtype=bool)
        if n:
            head[:n] = np.arange(n) == np.searchsorted(
                graph.layer, graph.layer)
        head_wb = np.where(head[:n], graph.weight_bytes, 0).astype(np.float64)
        ext_b = np.where(np.asarray(eng._external_of, dtype=bool),
                         np.asarray(eng._new_in_bytes, dtype=np.float64), 0.0)

        dram_bw = float(acc.dram_bw_bits_per_cc)
        self._dram_cc_per_byte = 8.0 / dram_bw
        dram_wt = np.zeros(n + 1, dtype=np.float32)
        dram_ext = np.zeros(n + 1, dtype=np.float32)
        dram_wt[:n] = head_wb * self._dram_cc_per_byte
        dram_ext[:n] = ext_b * self._dram_cc_per_byte
        # DRAM-port FCFS offsets are genome-independent (service order is
        # wavefront slot order, releases all 0): per wavefront, the end
        # offset of each member's external-input and weight fetch relative
        # to the port's free time on entry — NEG marks "no fetch"
        d_ext = dram_ext[wf]                       # (L, W)
        d_wt = dram_wt[wf]
        tot = d_ext + d_wt
        pre = np.cumsum(tot, axis=1) - tot
        ext_off = np.where(d_ext > 0, pre + d_ext, NEG).astype(np.float32)
        wt_off = np.where(d_wt > 0, pre + tot, NEG).astype(np.float32)
        dram_off = np.maximum(ext_off, wt_off)     # one fused ready bound
        dram_tot = tot.sum(axis=1).astype(np.float32)  # (L,)

        # activation-memory accounting (the spill model): per-wavefront
        # allocated / discarded bytes and per-edge bytes for readbacks
        out_pad = np.concatenate(
            [np.asarray(eng._out_bytes, dtype=np.float64), [0.0]])
        ext_pad = np.concatenate([ext_b, [0.0]])
        disc_pad = np.concatenate(
            [np.asarray(eng._disc_bytes, dtype=np.float64), [0.0]])
        alloc_b = (out_pad + ext_pad)[wf].astype(np.float32)    # (L, W)
        disc_b = disc_pad[wf].astype(np.float32)
        self._act_cap = np.asarray(eng._act_cap0, dtype=np.float32)
        # mandatory off-chip traffic: once-per-layer weights + external
        # inputs — both a constant energy term and the DRAM-port floor of
        # `latency_lower_bound`
        self._dram_bytes_const = float(head_wb.sum() + ext_b.sum())
        self._dram_e_per_byte = 8.0 * float(acc.dram_energy_pj_per_bit)
        self._dram_e_const = self._dram_bytes_const * self._dram_e_per_byte
        self._dram_cc_const = self._dram_bytes_const * self._dram_cc_per_byte

        # channel routes flattened to dense core-pair tables; the flat bus
        # is channel 0 of a 1-channel fabric, shared-L1 has no transfers
        self.shared_l1 = bool(eng._shared_l1)
        if self.shared_l1:
            n_chan = 0
            route_inv = np.zeros((n_cores, n_cores, 1), dtype=np.float32)
            route_e = np.zeros((n_cores, n_cores), dtype=np.float32)
        elif eng._routes is not None:
            n_chan = eng._n_chan
            route_inv = np.zeros((n_cores, n_cores, n_chan), dtype=np.float32)
            route_e = np.zeros((n_cores, n_cores), dtype=np.float32)
            for u in range(n_cores):
                for v in range(n_cores):
                    if u == v:
                        continue
                    for ch in eng._routes[u][v]:
                        route_inv[u, v, ch] += 1.0 / eng._chan_bw[ch]
                        route_e[u, v] += eng._chan_e[ch]
        else:
            n_chan = 1
            off = 1.0 - np.eye(n_cores, dtype=np.float32)
            route_inv = (off / float(acc.bus_bw_bits_per_cc))[:, :, None]
            route_e = off * float(acc.bus_energy_pj_per_bit)
        self.n_chan = n_chan
        dev = self.device

        def t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

        i64, f32 = torch.int64, torch.float32
        self._t = {
            "wf": t(wf, i64),
            "member": t(wf < n),
            "pred_ids": t(pred_ids, i64),
            "pred_b": t(pred_b, f32),
            "succ_ids": t(succ_ids, i64),
            "succ_b": t(succ_b, f32),
            "edge_slot": t(edge_slot, i64),
            "out_bytes": t(
                np.concatenate([graph.out_bytes, [0]]).astype(np.float32)),
            "cyc_nc": t(cyc_nc),
            "ecs_nc": t(ecs_nc),
            "layer_pad": t(layer_pad, i64),
            "dram_off": t(dram_off),
            "dram_tot": t(dram_tot),
            "alloc_b": t(alloc_b),
            "disc_b": t(disc_b),
            "act_cap": t(self._act_cap),
            "route_inv": t(route_inv),
            "route_e": t(route_e),
            "layer_wb": t(np.asarray(eng._layer_wb, dtype=np.float32)),
            "w_cap": t(np.asarray(eng._w_cap, dtype=np.float32)),
        }
        # (n+1, L) one-hot of each CN's wavefront level (pad row all-zero):
        # projects per-CN byte columns onto per-level sums with one matmul
        lvl_oh = np.zeros((n + 1, n_levels), dtype=np.float32)
        lvl_oh[np.arange(n), level] = 1.0
        self._t["lvl_t"] = t(lvl_oh.T.copy())
        # channel transfers exist: a channel serialization per wavefront
        self.comm = bool(self.dmax) and not self.shared_l1
        # the scan's static tables (see `wavefront_scan_ref`)
        self._st = {"wf": self._t["wf"], "member": self._t["member"],
                    "wf_layer": t(layer_pad[wf], i64),
                    "dram": self._t["dram_off"], "tot": self._t["dram_tot"],
                    "act_cap": self._t["act_cap"],
                    "layer_wb": self._t["layer_wb"],
                    "w_cap": self._t["w_cap"]}
        if self.dmax:
            self._st["pu"] = t(wf_pred, i64)

        # numpy copies for the float64 lower bound
        self._np_pred_ids = pred_ids
        self._np_cyc64 = np.where(feas, tab.cycles, BIG)[sig]  # (n, C)
        self._np_layer = np.asarray(graph.layer, dtype=np.int64)

    # ---- scoring ------------------------------------------------------------
    def scan_args(self, genomes: torch.Tensor):
        """The arguments of the scan over wavefronts for a chunk of (P, G)
        int64 genomes on this fitness's device: ``(xs, st, kwargs)``, as
        `wavefront_scan` and `wavefront_scan_ref` take them after the
        genomes."""
        xs, _ = self._hoist(genomes)
        return xs, self._st, self._scan_kwargs()

    def _scan_kwargs(self) -> dict:
        return dict(n=self.n, n_chan=self.n_chan, segment=self.segment_mode)

    def _hoist(self, genomes: torch.Tensor):
        """The scan's per-wavefront inputs for (P, G) genomes, and the
        per-CN tensors the sums after the scan need."""
        j = self._t
        dev = self.device
        n, n_cores, n_chan = self.n, self.n_cores, self.n_chan

        # population-last layout throughout: per-CN tables are (n+1, P),
        # per-level slices (W, P) — gathers over the leading CN/level axis
        # land directly in loop layout and every reduction runs over a
        # leading axis with P as the contiguous minor dimension
        core_ng = genomes.t()[j["layer_pad"]]         # (n+1, P)
        ids_pad = torch.arange(n + 1, device=dev)[:, None]
        cyc_ng = j["cyc_nc"][ids_pad, core_ng]        # (n+1, P)
        ecs_ng = j["ecs_nc"][ids_pad, core_ng]

        # fresh-byte dedup, exactly as the engine's `sent_to`/`remaining_new`
        # bookkeeping but hoisted out of the time loop (it depends only on
        # the allocation): a producer ships to a core once — the first
        # crossing consumer on that core pays min(edge bytes, remaining
        # budget), the budget starting at the producer's out_bytes
        fresh8_pred = None
        if not self.shared_l1 and self.dmax:
            ucore = core_ng[:, None]                      # (n+1, 1, P)
            scr = core_ng[j["succ_ids"]]                  # (n+1, S, P)
            crossing = (j["succ_b"][:, :, None] > 0) & (scr != ucore)
            tri = torch.tril(torch.ones((self.smax, self.smax),
                                        dtype=torch.bool, device=dev),
                             diagonal=-1)
            dup = ((scr[:, :, None] == scr[:, None, :])
                   & crossing[:, None] & tri[None, :, :, None])
            first = crossing & ~torch.any(dup, dim=2)
            rem = j["out_bytes"][:, None].expand(core_ng.shape)
            fresh_cols = []
            for s in range(self.smax):
                eb = torch.where(first[:, s], j["succ_b"][:, s, None], 0.0)
                f = torch.minimum(eb, rem)
                rem = rem - f
                fresh_cols.append(f)
            fresh_succ = torch.stack(fresh_cols, dim=1)   # (n+1, S, P)
            fresh8_pred = 8.0 * fresh_succ[
                j["pred_ids"], j["edge_slot"]]            # (n+1, D, P)

        # hoist every genome-dependent per-wavefront gather AND every
        # carry-independent per-level reduction out of the scan: each step
        # then touches only its own slices plus the carried finish/resource
        # state
        wf = j["wf"]                                   # (L, W)
        member = j["member"]                           # (L, W) bool
        cyc_x = cyc_ng[wf]                             # (L, W, P)
        cw_x = core_ng[wf]
        xs = {"cyc": cyc_x, "cw": cw_x}
        comm = self.comm
        serialize = self.contention == "serialize"
        cores = torch.arange(n_cores, device=dev)
        on = ((cw_x[:, None] == cores[None, :, None, None])
              & member[:, None, :, None])              # (L, C, W, P)
        if serialize:
            xs["on"] = on
        else:
            # backlog mode reduces `on` away up front (per-core added queue
            # occupancy of the whole wavefront) and scatter-maxes the
            # per-core frontier in-step
            xs["sc"] = torch.sum(torch.where(on, cyc_x[:, None], 0.0),
                                 dim=2)                # (L, C, P)
        if comm:
            # bundle each consumer's crossing transfers into one FCFS item
            # per channel: occupancy = sum of its fresh-byte hop times on
            # that channel, release = the latest producer finish — computed
            # on the compact (n+1, D, P) pred view, then gathered per level
            pucn = core_ng[j["pred_ids"]]              # (n+1, D, P)
            crossn = ((j["pred_b"][:, :, None] > 0)
                      & (pucn != core_ng[:, None]))
            f8n = fresh8_pred * crossn                 # (n+1, D, P)
            occn = torch.sum(
                f8n[..., None] * j["route_inv"][pucn, core_ng[:, None]],
                dim=1)                                 # (n+1, P, n_chan)
            xs["cross"] = crossn[wf]                   # (L, W, D, P)
            xs["occ"] = occn.movedim(2, 1)[wf].permute(0, 2, 1, 3)
        if self.model_spills:
            # bytes allocated per CN on its memory-pool core (own outputs,
            # external inputs, and incoming fresh activations) and bytes
            # freed when the wavefront retires (fully-consumed inputs plus
            # the incoming copies themselves) — reduced to per-core (L, C,
            # P) sums here so the loop only tracks occupancy vs capacity
            aw = j["alloc_b"][:, :, None].expand(cyc_x.shape)
            fw = j["disc_b"][:, :, None].expand(cyc_x.shape)
            if comm:
                # incoming fresh copies land on the consumer's memory core
                fbn = torch.sum(f8n, dim=1) / 8.0      # (n+1, P)
                aw = aw + fbn[wf]
            aw = torch.where(member[:, :, None], aw, 0.0)  # (L, W, P)
            if self.shared_l1:
                # activations pool on core 0 under shared L1
                onm = (member[:, None, :, None] &
                       (cores[None, :, None, None] == 0))
                xs["mw"] = torch.zeros_like(cw_x)
            else:
                onm = on
                xs["mw"] = cw_x
            xs["aw"] = aw
            xs["ac"] = torch.sum(torch.where(onm, aw[:, None], 0.0), dim=2)
            fc = torch.sum(torch.where(onm, fw[:, None], 0.0), dim=2)
            if comm:
                # ...and are freed from the *producer's* core when the
                # consumer finishes: per-core mask-sums over the pred view
                # plus one static matmul onto the consumer's level
                fbe = f8n / 8.0                        # (n+1, D, P)
                cols = [j["lvl_t"] @ torch.sum(
                    torch.where(pucn == c, fbe, 0.0), dim=1)
                    for c in range(n_cores)]
                fc = fc + torch.stack(cols, dim=1)     # (L, C, P)
            xs["fc"] = fc

        post = {"ecs_ng": ecs_ng}
        if comm:
            post.update(f8n=f8n, pucn=pucn, core_ng=core_ng)
        return xs, post

    def _score(self, genomes: torch.Tensor):
        """genomes (P, G) int64 -> (latency (P,), energy (P,)) float32."""
        j = self._t
        xs, post = self._hoist(genomes)
        # the scan over wavefronts: one kernel launch on the fused route
        if self.route == "fused":
            out = wavefront_scan(genomes, xs, self._st, **self._scan_kwargs())
        else:
            out = wavefront_scan_ref(
                genomes, xs, self._st,
                serialize=(self._serialize_t
                           if self.contention == "serialize" else None),
                **self._scan_kwargs())
        finish, _, chan_free, dram_free, spilled, dram_x = out

        if self.model_spills and self.dmax:
            # spill readback resolves after the loop: a CN spills exactly
            # once, at its own level, and every consumer sits at a strictly
            # later level — so the per-edge min(spilled[producer],
            # edge_bytes) reads the same value here as it would inside it
            dram_x = dram_x + torch.sum(
                torch.minimum(spilled[j["pred_ids"]],
                              j["pred_b"][:, :, None]), dim=(0, 1))

        # spill traffic occupies the DRAM port too, but its interleaving
        # with the fetch stream is timing-dependent — account for it as a
        # lump extension of the port busy time
        latency = torch.maximum(torch.amax(finish, dim=0),
                                dram_free + dram_x * self._dram_cc_per_byte)
        latency = torch.maximum(latency, torch.amax(chan_free, dim=0))
        energy = (torch.sum(post["ecs_ng"][:self.n], dim=0)
                  + self._dram_e_const + dram_x * self._dram_e_per_byte)
        if self.comm:
            pucn, core_ng = post["pucn"], post["core_ng"]
            energy = energy + torch.sum(
                post["f8n"] * j["route_e"][pucn, core_ng[:, None]],
                dim=(0, 1))
        return latency, energy

    # ---- public API -------------------------------------------------------
    def _as_matrix(self, genomes) -> np.ndarray:
        g = np.ascontiguousarray(np.asarray(genomes, dtype=np.int64))
        if g.ndim == 1:
            g = g[None, :]
        return g

    def chunk_size(self, k: int) -> int:
        """Genomes per `_score` call when `scores` gets `k` genomes.  At
        least 2: with one genome the population axis would collapse and the
        sums over CNs would take another reduction order than in a batch,
        so a lone genome would not score as it does among others."""
        return min(self.max_batch, max(2, _pow2_at_least(k)))

    def scores(self, genomes) -> np.ndarray:
        """Approximate `(K, 2)` `[latency_cc, energy_pj]` for `(K, G)`
        genomes. Values rank; they are not the engine's exact metrics."""
        g = self._as_matrix(genomes)
        k = g.shape[0]
        out = np.empty((k, 2), dtype=np.float64)
        chunk = self.chunk_size(k)
        for o in range(0, k, chunk):
            part = g[o:o + chunk]
            m = part.shape[0]
            if m < chunk:
                part = np.concatenate(
                    [part, np.repeat(part[-1:], chunk - m, axis=0)])
            lat, en = self._score(torch.as_tensor(part, device=self.device))
            out[o:o + m] = torch.stack([lat, en], dim=1).cpu().numpy()[:m]
        return out

    def scalar_scores(self, genomes, objective: str = "edp") -> np.ndarray:
        """Scalarized approximate scores (lower is better)."""
        if objective not in _OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}")
        s = self.scores(genomes)
        if objective == "latency":
            return s[:, 0]
        if objective == "energy":
            return s[:, 1]
        return s[:, 0] * s[:, 1]

    def rescore(self, genomes) -> np.ndarray:
        """Exact `(K, 2)` metrics through the Python engine — the oracle the
        prefilter's survivors are re-scored with (bit-identical to
        `engine.evaluate`)."""
        return self.engine.evaluate_population(
            self._as_matrix(genomes), self.priority, segment=self.segment,
            strict_layers=self.strict_layers)

    def latency_lower_bound(self, genomes) -> np.ndarray:
        """Provable `(K,)` latency floor: max of the zero-contention
        critical path, the busiest core's total work, and the mandatory
        DRAM traffic time. Never above `engine.evaluate`'s latency (up to
        float-summation rounding; compare with ~1e-9 rtol)."""
        g = self._as_matrix(genomes)
        k, n = g.shape[0], self.n
        core_of = g[:, self._np_layer]                       # (K, n)
        cyc = self._np_cyc64[np.arange(n)[None, :], core_of]  # (K, n)
        cp = np.zeros((k, n + 1), dtype=np.float64)
        pred = self._np_pred_ids
        for v in range(n):
            if self.dmax:
                cp[:, v] = cyc[:, v] + np.max(cp[:, pred[v]], axis=1,
                                              initial=0.0)
            else:
                cp[:, v] = cyc[:, v]
        busy = np.zeros((k, self.n_cores), dtype=np.float64)
        np.add.at(busy, (np.arange(k)[:, None], core_of), cyc)
        lb = np.maximum(cp.max(axis=1), busy.max(axis=1))
        return np.maximum(lb, self._dram_cc_const)

    def prefilter(self, objective: str = "edp"):
        """Batch scorer for `GeneticAllocator(prefilter=...)`: a callable
        mapping `(K, G)` genomes to `(K, M)` approximate objectives in the
        ranking space NSGA-II screening uses for `objective` — "edp" keeps
        both latency and energy columns, single-metric objectives rank on
        their column alone."""
        if objective not in _OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}")

        def score(genomes: np.ndarray) -> np.ndarray:
            s = self.scores(genomes)
            if objective == "latency":
                return s[:, :1]
            if objective == "energy":
                return s[:, 1:]
            return s

        return score


def get_batched_fitness(engine, priority: str = "latency",
                        segment: bool = True, strict_layers: bool = False,
                        use_kernel: bool = True,
                        contention: str | None = None,
                        device=None) -> BatchedFitness:
    """`BatchedFitness` for `engine` on `device` (None: CUDA), cached on the
    engine instance so one GA run (and every explore() hitting the session's
    engine cache) pays the wavefront precompute once per configuration."""
    dev = resolve_device(device)
    cache = getattr(engine, "_batched_fitness", None)
    if cache is None:
        cache = engine._batched_fitness = {}
    key = (priority, segment, strict_layers, use_kernel, contention, str(dev))
    bf = cache.get(key)
    if bf is None:
        bf = cache[key] = BatchedFitness(
            engine, priority, segment=segment, strict_layers=strict_layers,
            use_kernel=use_kernel, contention=contention, device=dev)
    return bf
