"""Stream: one-call design-space-exploration entry point (paper Fig. 3).

    result = explore(workload, accelerator, granularity="line",
                     objective="edp", priority="latency")

runs Steps 1-5: CN identification (HW-dataflow-aware minimum tiles), R-tree
dependency generation, intra-core cost extraction, GA layer-core allocation
(NSGA-II on [latency, energy]), and prioritized multi-core scheduling.

This module is the *single-point* compatibility surface.  The sweep-native
API — `ArchSpec`, `DesignSpace`, `ExplorationSession` with parallel
executors and a persistent result store — lives in `repro_torch.api`; the
functions here delegate to a shared default `ExplorationSession`, which owns
the graph/engine caches.  `device` names where the GA prefilter's batched
fitness runs: None means CUDA, and a machine without CUDA raises instead of
falling back to the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.depgraph import CNGraph
from repro_torch.core.ga import GAResult
from repro_torch.core.scheduler import ScheduleEngine, ScheduleResult
from repro_torch.core.workload import Workload
from repro_torch.hw.accelerator import Accelerator


def core_symmetry_canonicalize(accelerator: Accelerator):
    """Canonical-form function exploiting identical-core symmetry.

    On a homogeneous multi-core, relabeling the identical cores of an
    allocation cannot change the schedule's latency/energy bit-for-bit: the
    cost tables, weight/activation capacities and AiMC flags of equal cores
    are equal, the bus and DRAM ports are shared, and the event loop touches
    core ids only through those per-core arrays — a permutation of identical
    cores permutes the loop state exactly. Cores are canonicalized to their
    group's member ids in order of first appearance, which is *prefix-
    stable*: the canonical form of a genome prefix depends only on that
    prefix, so GA offspring share canonical allocation prefixes with their
    parents and the scheduler's segment checkpoints hit across the whole
    symmetry class. Returns None when every core is unique.

    Cores are grouped by their *content* — the `name` label cannot affect
    any cost or capacity, so "tpu0" and "tpu1" with equal specs are one
    group.  With a cluster topology, groups are additionally split by
    cluster: two content-equal cores on different chiplets are *not*
    interchangeable (their transfers take different routes), so only
    within-cluster permutations are canonicalized."""
    topo = accelerator.topology
    if topo is None:
        cluster_of = [0] * accelerator.n_cores
    else:
        c2c = topo.core_to_cluster()
        cluster_of = [c2c[c.name] for c in accelerator.cores]
    groups: dict = {}
    for i, c in enumerate(accelerator.cores):
        groups.setdefault((cluster_of[i], dataclasses.replace(c, name="")),
                          []).append(i)
    sym = {i: tuple(members) for members in
           (m for m in groups.values() if len(m) > 1) for i in members}
    if not sym:
        return None

    def canonicalize(genome) -> np.ndarray:
        remap: dict[int, int] = {}
        next_slot: dict[tuple, int] = {}
        out = np.empty(len(genome), dtype=np.int64)
        for idx, g in enumerate(genome):
            g = int(g)
            members = sym.get(g)
            if members is not None:
                m = remap.get(g)
                if m is None:
                    k = next_slot.get(members, 0)
                    m = members[k]
                    next_slot[members] = k + 1
                    remap[g] = m
                g = m
            out[idx] = g
        return out

    return canonicalize


def core_symmetry_cache_key(accelerator: Accelerator):
    """Genome-memo key: byte string of the canonical form (see
    `core_symmetry_canonicalize`), so genomes equivalent under identical-core
    permutations share one GA cache entry. Returns None when every core is
    unique (no symmetry to exploit)."""
    canon = core_symmetry_canonicalize(accelerator)
    if canon is None:
        return None
    return lambda genome: canon(genome).tobytes()


def hw_min_tiles(accelerator: Accelerator) -> dict[str, int]:
    """HW-dataflow awareness: CNs minimally encompass every dim spatially
    unrolled in any core (paper Sec. III-A principle 2)."""
    out: dict[str, int] = {}
    for core in accelerator.cores:
        for dim, u in core.dataflow:
            if dim in ("OY", "OX"):
                out[dim] = max(out.get(dim, 1), u)
    return out


@dataclasses.dataclass
class StreamResult:
    schedule: ScheduleResult
    allocation: np.ndarray
    ga: GAResult | None
    graph: CNGraph
    runtime_s: float
    granularity: object

    @property
    def latency_cc(self) -> float:
        return self.schedule.latency_cc

    @property
    def energy_pj(self) -> float:
        return self.schedule.energy_pj

    @property
    def edp(self) -> float:
        return self.schedule.edp

    @property
    def peak_mem_bytes(self) -> float:
        return self.schedule.peak_mem_bytes


def _session():
    # imported lazily to keep `repro_torch.core` importable without (and
    # before) the `repro_torch.api` package
    from repro_torch.api.session import default_session
    return default_session()


def build_graph(workload: Workload, accelerator: Accelerator, granularity,
                use_rtree: bool = True) -> CNGraph:
    return _session().graph(workload, accelerator, granularity,
                            use_rtree=use_rtree)


def evaluate_allocation(
    workload: Workload,
    accelerator: Accelerator,
    allocation,
    granularity="line",
    priority: str = "latency",
    graph: CNGraph | None = None,
    engine: ScheduleEngine | None = None,
) -> ScheduleResult:
    """Schedule a fixed layer-core allocation (used by validation benches).

    Pass `engine` (from a previous call or `ScheduleEngine(...)`) to reuse the
    precomputed CSR graph + cost tables across many allocations."""
    return _session().evaluate_allocation(
        workload, accelerator, allocation, granularity=granularity,
        priority=priority, graph=graph, engine=engine)


def evaluate_allocations(
    workload: Workload,
    accelerator: Accelerator,
    allocations,
    granularity="line",
    priority: str = "latency",
) -> np.ndarray:
    """Population-batched fitness: (P, G) allocation matrix -> (P, 2)
    [latency_cc, energy_pj], scheduled through one shared engine whose
    segment-prefix checkpoints are reused across the whole batch."""
    return _session().evaluate_allocations(
        workload, accelerator, allocations, granularity=granularity,
        priority=priority)


def explore(
    workload: Workload,
    accelerator: Accelerator,
    granularity="line",
    objective: str = "edp",            # 'edp' | 'latency' | 'energy'
    priority: str = "latency",
    pop_size: int = 24,
    generations: int = 16,
    seed: int = 0,
    initial_allocations=(),
    prefilter: bool | None = None,
    device=None,
) -> StreamResult:
    return _session().explore(
        workload, accelerator, granularity=granularity, objective=objective,
        priority=priority, pop_size=pop_size, generations=generations,
        seed=seed, initial_allocations=initial_allocations,
        prefilter=prefilter, device=device)


def explore_granularity(
    workload: Workload,
    accelerator: Accelerator,
    granularities=None,   # default: repro_torch.api.session.DEFAULT_GRANULARITIES
    objective: str = "edp",
    **kw,
) -> dict:
    """Co-explore scheduling granularity with allocation (paper Sec. V
    summary: "quantitatively and automatically co-explore the optimal
    scheduling granularity"). Returns {granularity: StreamResult} plus the
    objective-best key under 'best' — legacy shape; prefer
    `ExplorationSession.explore_granularity`, which returns a typed
    `GranularitySweep` instead of mixing the winner into the results dict."""
    kw = dict(kw, objective=objective)
    if granularities is not None:
        kw["granularities"] = granularities
    sweep = _session().explore_granularity(workload, accelerator, **kw)
    results: dict = dict(sweep.results)
    results["best"] = sweep.best_label
    return results
