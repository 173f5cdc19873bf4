"""Stream Step 4 substrate: NSGA-II genetic algorithm (Deb et al. [7]).

Genome: integer vector, gene g = core id allocated to allocatable unit g
(a layer in the reproduction; a layer-block in the TPU planner). Operators
per the paper: ordered (segment) crossover with p=0.3; mutation with p=0.7,
choosing uniformly between a bit flip (re-allocate one unit to a different
feasible core) and a position flip (swap two units' allocations). Selection
is NSGA-II: fast non-dominated sorting + crowding distance, which spreads the
surviving individuals over the Pareto front.

The allocator is population-native: the population lives as a `(P, G)` int64
matrix, fitness is requested through `evaluate_population(genomes) -> (P, M)`
(a per-genome `evaluate` callable is accepted and adapted), cache keys are
hashed for the whole batch at once, and only the cache-missing unique rows
of each generation reach the evaluator — which can then exploit shared
allocation prefixes across the batch (see `ScheduleEngine.
evaluate_population`). The `pop + offspring` union is deduplicated by cache
key before environmental selection, so identical genomes cannot inflate the
fronts and waste crowding-distance slots on copies.

An optional approximate-fitness `prefilter` (see `repro_torch.core.vectorized.
BatchedFitness`) screens each generation's novel offspring: it ranks them by
approximate NSGA-II survivorship and drops the bottom `1 - prefilter_keep`
fraction before they ever reach the exact evaluator. Approximate objectives
are used for that ranking only — every objective value entering selection or
the returned result comes from the exact evaluator.

Determinism contract: random draws are consumed genome-by-genome in the
same order as the original scalar implementation, so a fixed `seed`
reproduces the pre-vectorization evolution trajectory bit-for-bit (with
`dedup=False`; deduplication intentionally changes survivor sets when
clones occur).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# NSGA-II machinery
# ---------------------------------------------------------------------------

def fast_nondominated_sort(objs: np.ndarray) -> list[np.ndarray]:
    """objs: (N, M) minimization objectives -> list of fronts (index arrays)."""
    n = objs.shape[0]
    # dominated[i,j] = i dominates j
    le = np.all(objs[:, None, :] <= objs[None, :, :], axis=2)
    lt = np.any(objs[:, None, :] < objs[None, :, :], axis=2)
    dom = le & lt
    n_dominators = dom.sum(axis=0)
    fronts: list[np.ndarray] = []
    remaining = np.arange(n)
    counts = n_dominators.copy()
    while remaining.size:
        mask = counts[remaining] == 0
        front = remaining[mask]
        if front.size == 0:  # numerical tie safety
            front = remaining[counts[remaining] == counts[remaining].min()]
        fronts.append(front)
        remaining = np.setdiff1d(remaining, front, assume_unique=True)
        if remaining.size:
            counts[remaining] -= dom[np.ix_(front, remaining)].sum(axis=0)
    return fronts


def crowding_distance(objs: np.ndarray) -> np.ndarray:
    n, m = objs.shape
    if n <= 2:
        return np.full(n, np.inf)
    dist = np.zeros(n)
    for k in range(m):
        order = np.argsort(objs[:, k], kind="stable")
        lo, hi = objs[order[0], k], objs[order[-1], k]
        dist[order[0]] = dist[order[-1]] = np.inf
        if hi > lo:
            dist[order[1:-1]] += (objs[order[2:], k] - objs[order[:-2], k]) / (hi - lo)
    return dist


# ---------------------------------------------------------------------------
# the GA loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GAResult:
    pareto_genomes: np.ndarray        # (P, G)
    pareto_objs: np.ndarray           # (P, M)
    best_genome: np.ndarray           # scalarized best (first objective product)
    best_objs: np.ndarray
    history: list[float]              # best scalarized fitness per generation
    evaluations: int = 0              # unique genomes actually evaluated
    queries: int = 0                  # fitness lookups incl. memo hits
    cache_hits: int = 0               # queries served by the genome memo
    prefilter_screened: int = 0       # offspring ranked by the prefilter
    prefilter_pruned: int = 0         # offspring it dropped before rescore

    @property
    def cache_hit_rate(self) -> float:
        return self.cache_hits / self.queries if self.queries else 0.0

    @property
    def prefilter_prune_rate(self) -> float:
        return (self.prefilter_pruned / self.prefilter_screened
                if self.prefilter_screened else 0.0)


class GeneticAllocator:
    """NSGA-II search over layer-core allocations (see module docstring).

    Pass per-genome `evaluate` (tuple of minimized objectives) or batched
    `evaluate_population` ((K, G) matrix -> (K, M) objectives); `run()`
    returns the best genome under `scalarize` plus the final Pareto front.

        >>> import numpy as np
        >>> ga = GeneticAllocator(
        ...     n_genes=4, feasible_cores=[(0, 1)] * 4,
        ...     evaluate=lambda g: (float(np.sum(g)), float(g[0]) + 1.0),
        ...     pop_size=8, generations=6, seed=0)
        >>> res = ga.run()
        >>> res.best_genome.tolist(), res.best_objs.tolist()
        ([0, 0, 0, 0], [0.0, 1.0])
        >>> ga.evaluations <= ga.queries    # memoized fitness
        True
    """

    def __init__(
        self,
        n_genes: int,
        feasible_cores: Sequence[Sequence[int]],   # per gene
        evaluate: Callable[[np.ndarray], tuple[float, ...]] | None = None,
        *,
        evaluate_population: Callable[[np.ndarray], np.ndarray] | None = None,
        pop_size: int = 32,
        generations: int = 24,
        crossover_p: float = 0.3,
        mutation_p: float = 0.7,
        scalarize: Callable[[np.ndarray], float] | None = None,
        seed: int = 0,
        patience: int = 8,
        cache_key: Callable[[np.ndarray], bytes] | None = None,
        dedup: bool = True,
        prefilter: Callable[[np.ndarray], np.ndarray] | None = None,
        prefilter_keep: float = 0.75,
        prefilter_min_batch: int = 8,
        tracer=None,
    ):
        if evaluate is None and evaluate_population is None:
            raise ValueError("pass evaluate= or evaluate_population=")
        self.n_genes = n_genes
        self.feasible = [np.asarray(f, dtype=np.int64) for f in feasible_cores]
        if any(f.size == 0 for f in self.feasible):
            raise ValueError("a gene has no feasible core")
        self.evaluate = evaluate
        if evaluate_population is None:
            evaluate_population = lambda M: np.array(  # noqa: E731
                [tuple(float(x) for x in evaluate(g)) for g in M], dtype=float)
        self.evaluate_population_fn = evaluate_population
        self.pop_size = max(4, pop_size)
        self.generations = generations
        self.crossover_p = crossover_p
        self.mutation_p = mutation_p
        # default scalarization: product of objectives (latency*energy = EDP)
        self.scalarize = scalarize or (lambda o: float(np.prod(o)))
        self.rng = np.random.default_rng(seed)
        self.patience = patience
        # memo key; callers may pass a canonicalizer that maps genomes
        # equivalent under a fitness-preserving symmetry (e.g. permutations
        # of identical cores) to one key, deduplicating their evaluations
        self.cache_key = cache_key
        self._cache: dict[bytes, tuple[float, ...]] = {}
        self.evaluations = 0
        self.queries = 0
        self.cache_hits = 0
        self.dedup = dedup
        # approximate-fitness offspring screening (see `_prefilter_offspring`):
        # `prefilter` maps a (K, G) genome batch to (K, M) approximate
        # objectives; each generation's *novel* offspring are ranked by
        # approximate NSGA-II survivorship and only the top `prefilter_keep`
        # fraction is exactly evaluated — the rest never enter the union.
        # Screening is skipped below `prefilter_min_batch` novel rows, where
        # the batched scorer's fixed cost outweighs the pruned exact work.
        self.prefilter = prefilter
        self.prefilter_keep = float(prefilter_keep)
        self.prefilter_min_batch = int(prefilter_min_batch)
        self.prefilter_screened = 0
        self.prefilter_pruned = 0
        # optional sim-time tracer (duck-typed like the JAX package's
        # repro.obs.Tracer): one span per generation on the generation-index
        # clock plus counter deltas.  The tracer only
        # observes the existing counters — search output is bit-identical
        # with tracing on or off.
        self.tracer = tracer

    # ---- batched genome hashing / fitness memo -----------------------------
    def _keys(self, genomes: np.ndarray) -> list[bytes]:
        """Cache key per row of a (K, G) genome matrix, hashed as one buffer
        when no symmetry canonicalizer is installed."""
        if self.cache_key is not None:
            return [self.cache_key(g) for g in genomes]
        buf = genomes.tobytes()
        step = genomes.shape[1] * genomes.itemsize
        return [buf[o:o + step] for o in range(0, len(buf), step)]

    def _eval_population(self, genomes: np.ndarray,
                         keys: list[bytes] | None = None) -> np.ndarray:
        """(K, M) objectives for a (K, G) matrix; only cache-missing unique
        rows reach the evaluator (as one batch, preserving first-seen order
        so prefix-sharing evaluators see parents before their offspring)."""
        if keys is None:
            keys = self._keys(genomes)
        cache = self._cache
        self.queries += len(keys)
        miss_rows: list[int] = []
        miss_keys: list[bytes] = []
        pending: set[bytes] = set()
        for r, k in enumerate(keys):
            if k not in cache and k not in pending:
                pending.add(k)
                miss_rows.append(r)
                miss_keys.append(k)
        self.cache_hits += len(keys) - len(miss_rows)
        if miss_rows:
            vals = np.asarray(
                self.evaluate_population_fn(genomes[miss_rows]), dtype=float)
            self.evaluations += len(miss_rows)
            for k, row in zip(miss_keys, vals):
                cache[k] = tuple(float(x) for x in row)
        return np.array([cache[k] for k in keys], dtype=float)

    def _eval(self, g: np.ndarray) -> tuple[float, ...]:
        """Single-genome fitness through the same memo (compat shim)."""
        g = np.ascontiguousarray(np.asarray(g, dtype=np.int64))
        key = self._keys(g[None, :])[0]
        self._eval_population(g[None, :], keys=[key])
        return self._cache[key]

    # ---- operators (legacy RNG draw order, matrix-row storage) -------------
    def _random_genome(self) -> np.ndarray:
        return np.array([f[self.rng.integers(f.size)] for f in self.feasible])

    def _mutate_inplace(self, g: np.ndarray) -> None:
        rng = self.rng
        if rng.random() < 0.5 or self.n_genes < 2:
            # bit flip: allocate one unit to a different feasible core
            i = int(rng.integers(self.n_genes))
            opts = self.feasible[i]
            if opts.size > 1:
                choices = opts[opts != g[i]]
                g[i] = choices[rng.integers(choices.size)]
        else:
            # position flip: swap two units' allocations (if mutually feasible)
            i, j = rng.integers(0, self.n_genes, size=2)
            if g[j] in self.feasible[i] and g[i] in self.feasible[j]:
                g[i], g[j] = g[j], g[i]

    # ---- approximate-fitness offspring screening ---------------------------
    def _prefilter_offspring(self, off: np.ndarray) -> np.ndarray:
        """Screen one offspring batch through the approximate evaluator.

        Novel (memo-missing) offspring are scored approximately and ranked
        exactly the way NSGA-II environmental selection would rank them
        (nondominated front, then crowding distance); only the top
        `prefilter_keep` fraction survives to exact evaluation — the rest
        never enter the union. Memo-hit offspring are free and always pass.
        The approximate objectives never leave this method: survivors are
        re-scored by the exact evaluator through the fitness memo, so every
        objective value the search stores comes from the oracle."""
        keys = self._keys(off)
        novel = [r for r, k in enumerate(keys) if k not in self._cache]
        if len(novel) < self.prefilter_min_batch or self.prefilter_keep >= 1.0:
            return off
        approx = np.asarray(self.prefilter(off[novel]), dtype=float)
        n_keep = int(np.ceil(self.prefilter_keep * len(novel)))
        order: list[int] = []
        for front in fast_nondominated_sort(approx):
            cd = crowding_distance(approx[front])
            order.extend(front[np.argsort(-cd, kind="stable")].tolist())
        self.prefilter_screened += len(novel)
        self.prefilter_pruned += len(novel) - n_keep
        keep = set(range(len(off))) - set(novel)
        keep |= {novel[i] for i in order[:n_keep]}
        return off[sorted(keep)]  # generation order preserved

    # ---- main loop ---------------------------------------------------------
    def run(self, initial: Sequence[np.ndarray] = ()) -> GAResult:
        P, G = self.pop_size, self.n_genes
        rows = [np.asarray(g, dtype=np.int64) for g in initial][:P]
        while len(rows) < P:
            rows.append(self._random_genome())
        pop = np.ascontiguousarray(np.stack(rows).astype(np.int64, copy=False))
        objs = self._eval_population(pop)
        history: list[float] = []
        stale = 0
        rng = self.rng
        for gen in range(self.generations):
            if self.tracer is not None:
                ev0, ch0 = self.evaluations, self.cache_hits
                pf0 = self.prefilter_pruned
            # ---- variation: tournament parents -> offspring -----------------
            # scalarize once per generation, not once per tournament comparison
            scal = [self.scalarize(o) for o in objs]
            len_pop = len(pop)
            off = np.empty((P, G), dtype=np.int64)
            for k in range(P):
                i, j = rng.integers(0, len_pop, size=2)
                child = pop[i if scal[i] <= scal[j] else j].copy()
                if rng.random() < self.crossover_p:
                    # ordered (two-point segment) crossover
                    mate = pop[int(rng.integers(len_pop))]
                    a, b = sorted(rng.integers(0, G, size=2))
                    child[a:b + 1] = mate[a:b + 1]
                if rng.random() < self.mutation_p:
                    self._mutate_inplace(child)
                off[k] = child
            if self.prefilter is not None:
                off = self._prefilter_offspring(off)
            # ---- NSGA-II environmental selection on parents+offspring -------
            union = np.ascontiguousarray(np.concatenate([pop, off]))
            ukeys = self._keys(union)
            uobjs = self._eval_population(union, keys=ukeys)
            if self.dedup:
                # clones of one genome would enter the sort as duplicate rows
                # (same front, zero crowding distance) and eat survivor slots
                seen: set[bytes] = set()
                keep = [r for r, k in enumerate(ukeys)
                        if not (k in seen or seen.add(k))]
                if len(keep) < len(ukeys):
                    union = union[keep]
                    uobjs = uobjs[keep]
            fronts = fast_nondominated_sort(uobjs)
            survivors: list[int] = []
            for front in fronts:
                if len(survivors) + front.size <= P:
                    survivors.extend(front.tolist())
                else:
                    cd = crowding_distance(uobjs[front])
                    order = front[np.argsort(-cd, kind="stable")]
                    survivors.extend(order[: P - len(survivors)].tolist())
                    break
            pop = np.ascontiguousarray(union[survivors])
            objs = uobjs[survivors]
            best = min(self.scalarize(o) for o in objs)
            if history and best >= history[-1] - 1e-12:
                stale += 1
            else:
                stale = 0
            history.append(best)
            if self.tracer is not None:
                d_ev = self.evaluations - ev0
                d_ch = self.cache_hits - ch0
                d_pf = self.prefilter_pruned - pf0
                self.tracer.add_span(
                    "ga.generation", float(gen), float(gen + 1),
                    evaluations=d_ev, cache_hits=d_ch,
                    prefilter_pruned=d_pf, best=best)
                self.tracer.count("ga.generations")
                self.tracer.count("ga.evaluations", d_ev)
                self.tracer.count("ga.cache_hits", d_ch)
                self.tracer.count("ga.prefilter_pruned", d_pf)
                self.tracer.observe("ga.best", best)
            if stale >= self.patience:  # "after the desired metric saturates"
                break
        # ---- results -------------------------------------------------------
        fronts = fast_nondominated_sort(objs)
        pareto = fronts[0]
        scal = np.array([self.scalarize(o) for o in objs])
        best_i = int(np.argmin(scal))
        return GAResult(
            pareto_genomes=pop[pareto].copy(),
            pareto_objs=objs[pareto].copy(),
            best_genome=pop[best_i].copy(),
            best_objs=objs[best_i].copy(),
            history=history,
            evaluations=self.evaluations,
            queries=self.queries,
            cache_hits=self.cache_hits,
            prefilter_screened=self.prefilter_screened,
            prefilter_pruned=self.prefilter_pruned,
        )
