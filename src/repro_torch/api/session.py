"""ExplorationSession, the single-point part: owned graph/engine caches and
Stream's five steps for one design point.

The JAX package's session (`repro/api/session.py`) also runs declarative
sweeps through executors into a persistent result store, with warm starts,
resilience and serving sweeps.  The port keeps only what `explore()` needs:
the content-keyed FIFO caches, `graph`, `engine`, `explore`,
`evaluate_allocation` and `evaluate_allocations`.  `device` names where the
GA prefilter's batched fitness (`repro_torch.core.vectorized`) runs; None
means CUDA, and it raises when CUDA is absent.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.allocator import feasible_cores_per_layer
from repro_torch.core.cn import identify_cns
from repro_torch.core.costmodel import CostModel
from repro_torch.core.depgraph import CNGraph, build_cn_graph
from repro_torch.core.ga import GeneticAllocator
from repro_torch.core.scheduler import ScheduleEngine, ScheduleResult, \
    get_engine
from repro_torch.core.stream_api import StreamResult, \
    core_symmetry_cache_key, core_symmetry_canonicalize, hw_min_tiles
from repro_torch.core.workload import Workload
from repro_torch.hw.accelerator import Accelerator

# ---------------------------------------------------------------------------
# construction cache keys: the CN graph depends only on (workload content,
# granularity, HW minimum tiles) and the engine additionally on the
# accelerator — both are pure builds, so sessions memoize them
# content-keyed (safe under workload mutation).
# ---------------------------------------------------------------------------

def _granularity_key(granularity) -> tuple:
    if isinstance(granularity, dict):
        return ("per-layer", tuple(sorted(granularity.items())))
    return ("uniform", granularity)


def _effective_min_tile(granularity, min_tile: dict) -> tuple:
    """Restrict `min_tile` to the components that can affect the CN split.

    `resolve_splits` only consults `min_tile[d]` when the granularity asks
    for more than one part along `d` and the tile is > 1, so e.g. an OX
    unroll constraint is irrelevant to row-band granularities — dropping it
    from the cache key lets architectures with different dataflows share one
    CN graph when their splits provably coincide."""
    if granularity == "layer":
        return ()
    if granularity == "line":
        dims = ("OY",)
    elif isinstance(granularity, tuple) and granularity[0] == "tile":
        n_ox = int(granularity[2]) if len(granularity) > 2 else 1
        dims = tuple(d for d, parts in (("OY", int(granularity[1])), ("OX", n_ox))
                     if parts > 1)
    else:  # per-layer dict or unknown: keep the full constraint
        return tuple(sorted(min_tile.items()))
    return tuple(sorted((d, v) for d, v in min_tile.items() if d in dims and v > 1))


def _graph_key(workload: Workload, granularity, min_tile: dict) -> tuple:
    return (workload.cache_key(), _granularity_key(granularity),
            _effective_min_tile(granularity, min_tile))


class FifoCache:
    """Bounded first-in-first-out cache.

    Eviction is strictly by *insertion* order — a lookup hit does not
    refresh an entry's position (this is FIFO, not LRU), which keeps the
    eviction order independent of access patterns and therefore
    deterministic across executors.  Hit/miss counters are exposed for the
    session's `cache_stats`.

        >>> c = FifoCache(limit=2)
        >>> c.put("a", 1); c.put("b", 2); c.put("c", 3)   # evicts "a"
        >>> c.get("a") is None, c.get("b"), (c.hits, c.misses)
        (True, 2, (1, 1))
    """

    _MISS = object()

    def __init__(self, limit: int):
        self.limit = int(limit)
        self._data: dict = {}
        self.hits = 0
        self.misses = 0

    def get(self, key):
        value = self._data.get(key, self._MISS)
        if value is self._MISS:
            self.misses += 1
            return None
        self.hits += 1
        return value

    def put(self, key, value) -> None:
        if key not in self._data and len(self._data) >= self.limit:
            self._data.pop(next(iter(self._data)))
        self._data[key] = value

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    def clear(self) -> None:
        self._data.clear()


class ExplorationSession:
    """Owns exploration state: the graph/engine caches shared by every
    `explore` of the session.

        >>> from repro_torch.configs.paper_workloads import squeezenet
        >>> from repro_torch.hw.catalog import mc_hom_tpu
        >>> session = ExplorationSession(device="cpu")
        >>> r = session.explore(squeezenet(), mc_hom_tpu(), ("tile", 32, 1),
        ...                     pop_size=4, generations=2)
        >>> r.latency_cc > 0, session.cache_stats["engine_entries"]
        (True, 1)
    """

    def __init__(self, cache_limit: int = 32, prefilter: bool = False,
                 prefilter_keep: float = 0.75, tracer=None, device=None):
        self._graphs = FifoCache(cache_limit)
        self._engines = FifoCache(cache_limit)
        # vectorized GA prefilter (repro_torch.core.vectorized.BatchedFitness):
        # rank each generation's novel offspring approximately and prune the
        # worst before exact rescoring. Off by default — approximate ranks
        # can steer the GA's search trajectory, so prefiltered runs are only
        # committed where their metrics are verified unchanged.
        self.prefilter = prefilter
        self.prefilter_keep = prefilter_keep
        # optional sim-time tracer (duck-typed like the JAX package's
        # repro.obs.Tracer): threaded into the schedule engine / GA of every
        # explore().  None by default — the instrumented paths pay one
        # branch, nothing else, and results are bit-identical either way.
        self.tracer = tracer
        # where the prefilter's batched fitness runs (None: CUDA); resolved
        # when the fitness is built, so a session that never prefilters
        # needs no device
        self.device = device

    # ---- cache introspection --------------------------------------------
    @property
    def cache_stats(self) -> dict[str, int]:
        return {"graph_hits": self._graphs.hits,
                "graph_misses": self._graphs.misses,
                "graph_entries": len(self._graphs),
                "engine_hits": self._engines.hits,
                "engine_misses": self._engines.misses,
                "engine_entries": len(self._engines)}

    def clear_caches(self) -> None:
        self._graphs.clear()
        self._engines.clear()

    # ---- construction-memoized building blocks ---------------------------
    def graph(self, workload: Workload, accelerator: Accelerator,
              granularity, use_rtree: bool = True) -> CNGraph:
        """CN graph for (workload content, granularity, HW min tiles)."""
        min_tile = hw_min_tiles(accelerator)
        key = (_graph_key(workload, granularity, min_tile), use_rtree)
        graph = self._graphs.get(key)
        if graph is None:
            cns = identify_cns(workload, granularity, min_tile)
            graph = build_cn_graph(workload, cns, use_rtree=use_rtree)
            self._graphs.put(key, graph)
        return graph

    def engine(self, workload: Workload, accelerator: Accelerator,
               granularity) -> ScheduleEngine:
        """Precomputed schedule engine (CSR graph + dense cost tables)."""
        min_tile = hw_min_tiles(accelerator)
        gkey = (_graph_key(workload, granularity, min_tile), True)
        key = (gkey, accelerator)
        graph = self.graph(workload, accelerator, granularity)
        hit = self._engines.get(key)
        if hit is not None and hit[0] is graph:
            return hit[1]
        engine = get_engine(graph, CostModel(workload, accelerator), accelerator)
        self._engines.put(key, (graph, engine))
        return engine

    # ---- single-point exploration ----------------------------------------
    def explore(
        self,
        workload: Workload,
        accelerator: Accelerator,
        granularity="line",
        objective: str = "edp",
        priority: str = "latency",
        pop_size: int = 24,
        generations: int = 16,
        seed: int = 0,
        initial_allocations=(),
        prefilter: bool | None = None,
        device=None,
    ) -> StreamResult:
        """Steps 1-5 for one design point (the former `explore()` body).

        `prefilter=True` (default: the session's setting) screens each GA
        generation's novel offspring through the batched approximate
        evaluator (`repro_torch.core.vectorized.BatchedFitness`, on `device`,
        default: the session's) and prunes the worst-ranked before exact
        rescoring; reported metrics always come from the exact engine."""
        # runtime_s is an operator-facing wall timing, excluded from content
        # keys and record equality  # staticcheck: allow(wall-clock)
        t0 = time.perf_counter()
        engine = self.engine(workload, accelerator, granularity)
        if self.tracer is not None:
            engine.tracer = self.tracer
        graph = engine.graph
        feas = feasible_cores_per_layer(workload, accelerator)

        strict = granularity == "layer"  # traditional LBL: no overlap
        canon = core_symmetry_canonicalize(accelerator)

        def evaluate_population(genomes: np.ndarray) -> np.ndarray:
            # fitness only needs latency/energy: timing model without traces,
            # resumed from the engine's shared segment-checkpoint store.
            # Genomes are scheduled in canonical form (bit-identical by the
            # identical-core symmetry backing the GA memo) so checkpoint
            # prefixes are shared across each whole symmetry class.
            if canon is not None:
                genomes = np.stack([canon(g) for g in genomes])
            return engine.evaluate_population(genomes, priority,
                                              strict_layers=strict)

        scalarize = {
            "edp": lambda o: float(o[0] * o[1]),
            "latency": lambda o: float(o[0]),
            "energy": lambda o: float(o[1]),
        }[objective]

        if prefilter is None:
            prefilter = self.prefilter
        prefilter_fn = None
        if prefilter:
            from repro_torch.core.vectorized import get_batched_fitness
            bf = get_batched_fitness(
                engine, priority=priority, strict_layers=strict,
                device=self.device if device is None else device)

            def prefilter_fn(genomes: np.ndarray) -> np.ndarray:
                # rank in canonical form so symmetry-equivalent genomes
                # screen identically (mirrors the exact path above)
                if canon is not None:
                    genomes = np.stack([canon(g) for g in genomes])
                return np.asarray(bf.scores(genomes))

        if len(workload) == 1 or all(len(f) == 1 for f in feas):
            alloc = np.array([f[0] for f in feas])
            ga_res = None
        else:
            # dedup=False: stored sweep records are content-keyed under the
            # promise that identical specs reproduce identical metrics, and
            # the pre-existing stores were built with clone-keeping NSGA
            # selection — union dedup changes survivor sets whenever clones
            # occur, which would silently invalidate every persisted record
            ga = GeneticAllocator(
                n_genes=len(workload), feasible_cores=feas,
                evaluate_population=evaluate_population,
                pop_size=pop_size, generations=generations,
                scalarize=scalarize, seed=seed,
                cache_key=core_symmetry_cache_key(accelerator),
                dedup=False,
                prefilter=prefilter_fn,
                prefilter_keep=self.prefilter_keep,
                tracer=self.tracer,
            )
            ga_res = ga.run(initial=initial_allocations)
            alloc = ga_res.best_genome

        final = engine.schedule(alloc, priority, strict_layers=strict)
        return StreamResult(
            schedule=final, allocation=alloc, ga=ga_res, graph=graph,
            runtime_s=time.perf_counter() - t0, granularity=granularity,  # staticcheck: allow(wall-clock)
        )

    def evaluate_allocation(
        self,
        workload: Workload,
        accelerator: Accelerator,
        allocation,
        granularity="line",
        priority: str = "latency",
        graph: CNGraph | None = None,
        engine: ScheduleEngine | None = None,
    ) -> ScheduleResult:
        """Schedule a fixed layer-core allocation (validation benches)."""
        if engine is None:
            if graph is not None:
                engine = get_engine(graph, CostModel(workload, accelerator),
                                    accelerator)
            else:
                engine = self.engine(workload, accelerator, granularity)
        return engine.schedule(np.asarray(allocation), priority,
                               strict_layers=(granularity == "layer"))

    def evaluate_allocations(
        self,
        workload: Workload,
        accelerator: Accelerator,
        allocations,
        granularity="line",
        priority: str = "latency",
    ) -> np.ndarray:
        """(P, 2) [latency_cc, energy_pj] for a (P, G) allocation matrix.

        The population-batched fitness path: one shared engine per
        (graph, arch) pair, with segment-prefix checkpoints reused across
        the whole batch (and across calls — the store lives on the engine)."""
        engine = self.engine(workload, accelerator, granularity)
        return engine.evaluate_population(
            allocations, priority, strict_layers=(granularity == "layer"))


# ---------------------------------------------------------------------------
# default session backing the `repro_torch.core.stream_api` wrappers
# ---------------------------------------------------------------------------
_DEFAULT_SESSION: ExplorationSession | None = None


def default_session() -> ExplorationSession:
    """Lazily created memory-only session shared by the legacy one-call API.

        >>> default_session() is default_session()
        True
    """
    global _DEFAULT_SESSION
    if _DEFAULT_SESSION is None:
        _DEFAULT_SESSION = ExplorationSession()
    return _DEFAULT_SESSION
