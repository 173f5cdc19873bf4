"""ExplorationSession: sweep-native exploration with owned caches, parallel
executors, and a persistent result store.

The session owns what used to be module-global state in
`repro_torch.core.stream_api` (CN-graph and engine caches), runs declarative
`DesignSpace`s through a pluggable executor (in-process serial, or a
`ProcessPoolExecutor` whose workers rebuild engines from the picklable
point specs), and streams `ExplorationRecord`s into a content-keyed JSONL
store — so re-running a sweep schedules only the points whose spec changed.

    session = ExplorationSession(cache_dir=".stream_cache")
    sweep = session.run(space, executor="process")
    sweep.best("edp"), sweep.pareto(("latency_cc", "energy_pj"))

`device` names where the GA prefilter's batched fitness
(`repro_torch.core.vectorized`) runs; None means CUDA, and it raises when
CUDA is absent.  It is never stored in a record or a content key.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, TimeoutError as \
    _FutureTimeout
from concurrent.futures.process import BrokenProcessPool
from typing import Callable, Iterable, Iterator, Mapping, Sequence

import numpy as np

try:                                   # advisory store-file locking (POSIX);
    import fcntl                       # single-line O_APPEND writes remain
except ImportError:                    # the fallback elsewhere
    fcntl = None

from repro_torch.api.archspec import ArchSpec
from repro_torch.api.resilience import (NO_RETRY, FailureRecord, FaultInjector,
                                  PointOutcome, RetryPolicy,
                                  StoreCorruptionError, StoreLockError)
from repro_torch.api.designspace import DesignPoint, DesignSpace, \
    arch_spec_similarity, granularity_label, order_points
from repro_torch.core.allocator import feasible_cores_per_layer
from repro_torch.core.cn import identify_cns
from repro_torch.core.costmodel import CostModel
from repro_torch.core.depgraph import CNGraph, build_cn_graph
from repro_torch.core.ga import GeneticAllocator
from repro_torch.core.scheduler import ScheduleEngine, ScheduleResult, get_engine
from repro_torch.core.stream_api import StreamResult, core_symmetry_cache_key, \
    core_symmetry_canonicalize, hw_min_tiles
from repro_torch.core.workload import Workload
from repro_torch.hw.accelerator import Accelerator

DEFAULT_GRANULARITIES = ("layer", ("tile", 8, 1), ("tile", 16, 1),
                         ("tile", 32, 1), ("tile", 64, 1))

_OBJECTIVE_METRIC = {"edp": "edp", "latency": "latency_cc",
                     "energy": "energy_pj"}


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

    def __init__(self, limit: int, on_evict: Callable | None = None):
        self.limit = int(limit)
        self._data: dict = {}
        self.hits = 0
        self.misses = 0
        self._on_evict = on_evict

    def get(self, key):
        value = self._data.get(key, self._MISS)
        if value is self._MISS:
            self.misses += 1
            return None
        self.hits += 1
        return value

    def put(self, key, value) -> None:
        if key not in self._data and len(self._data) >= self.limit:
            evicted = self._data.pop(next(iter(self._data)))
            if self._on_evict is not None:
                self._on_evict(evicted)
        self._data[key] = value

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    def clear(self) -> None:
        if self._on_evict is not None:
            for value in self._data.values():
                self._on_evict(value)
        self._data.clear()


@dataclasses.dataclass(frozen=True)
class ExplorationRecord:
    """Serializable outcome of one design point (one `explore()` call).

    Carries its full point spec, so the result is reproducible from the
    store alone; `metric()` resolves both objective names ('edp') and
    record field names ('latency_cc').

        >>> r = ExplorationRecord(key="k", workload="w", arch="a",
        ...     arch_key="ak", granularity="line", objective="edp",
        ...     priority="latency", latency_cc=2.0, energy_pj=3.0, edp=6.0,
        ...     peak_mem_bytes=0.0, act_peak_bytes=0.0, allocation=(0, 1),
        ...     ga_evaluations=0, runtime_s=0.0)
        >>> r.metric("edp"), r.metric("latency_cc")
        (6.0, 2.0)
        >>> ExplorationRecord.from_dict(r.to_dict()) == r
        True
    """

    key: str                       # DesignPoint.content_key()
    workload: str
    arch: str
    arch_key: str
    granularity: str               # canonical label, e.g. 'tile32x1'
    objective: str
    priority: str
    latency_cc: float
    energy_pj: float
    edp: float
    peak_mem_bytes: float
    act_peak_bytes: float
    allocation: tuple[int, ...]
    ga_evaluations: int
    runtime_s: float
    energy_breakdown: dict | None = None   # pj per component (mac/sram/...)
    spec: dict | None = None       # full point spec: result is reproducible
    from_store: bool = False       # True when served from the persistent store
    ga_warm_starts: int = 0        # store-backed allocations seeding the GA

    def metric(self, name: str) -> float:
        return float(getattr(self, _OBJECTIVE_METRIC.get(name, name)))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("from_store")
        d["allocation"] = list(self.allocation)
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "ExplorationRecord":
        d = dict(d)
        d.pop("from_store", None)
        d["allocation"] = tuple(int(x) for x in d["allocation"])
        return cls(**d)


def _demo_records() -> list[ExplorationRecord]:
    """Three tiny records for the query-function doctests."""
    mk = lambda key, arch, lat, e: ExplorationRecord(
        key=key, workload="w", arch=arch, arch_key=arch, granularity="line",
        objective="edp", priority="latency", latency_cc=lat, energy_pj=e,
        edp=lat * e, peak_mem_bytes=0.0, act_peak_bytes=0.0, allocation=(0,),
        ga_evaluations=0, runtime_s=0.0)
    return [mk("a", "A", 1.0, 4.0), mk("b", "B", 2.0, 2.0),
            mk("c", "A", 3.0, 3.0)]


def best_record(records: Sequence[ExplorationRecord],
                metric: str = "edp") -> ExplorationRecord:
    """The record minimizing `metric` ('edp' | 'latency' | 'energy' | any
    record field).

        >>> best_record(_demo_records(), "edp").key
        'a'
        >>> best_record(_demo_records(), "energy_pj").key
        'b'
    """
    if not records:
        raise ValueError("no records")
    return min(records, key=lambda r: r.metric(metric))


def pareto_records(records: Sequence[ExplorationRecord],
                   metrics: Sequence[str] = ("latency_cc", "energy_pj"),
                   ) -> list[ExplorationRecord]:
    """Non-dominated subset, all metrics minimized; input order preserved.

        >>> [r.key for r in pareto_records(_demo_records())]
        ['a', 'b']
    """
    vals = [tuple(r.metric(m) for m in metrics) for r in records]
    out = []
    for i, (r, v) in enumerate(zip(records, vals)):
        dominated = any(
            all(w[k] <= v[k] for k in range(len(v))) and w != v
            for j, w in enumerate(vals) if j != i)
        if not dominated:
            out.append(r)
    return out


def pivot_records(records: Sequence[ExplorationRecord], rows: str = "arch",
                  cols: str = "workload", value: str = "edp",
                  agg: Callable[[Sequence[float]], float] = min,
                  ) -> dict[str, dict[str, float]]:
    """Per-axis pivot (the paper's Fig.-13-style tables): rows x cols ->
    `agg` over the `value` metric of every matching record.

        >>> pivot_records(_demo_records(), rows="arch", value="latency_cc")
        {'A': {'w': 1.0}, 'B': {'w': 2.0}}
    """
    cells: dict[str, dict[str, list[float]]] = {}
    for r in records:
        row, col = str(getattr(r, rows)), str(getattr(r, cols))
        cells.setdefault(row, {}).setdefault(col, []).append(r.metric(value))
    return {row: {col: float(agg(vs)) for col, vs in colmap.items()}
            for row, colmap in cells.items()}


@dataclasses.dataclass
class GranularitySweep:
    """Typed result of a granularity co-exploration (no stringly 'best' key).

    Returned by `ExplorationSession.explore_granularity`: one full
    `StreamResult` per granularity label plus the objective-best label.

        >>> from repro_torch.configs.paper_workloads import squeezenet
        >>> from repro_torch.hw.catalog import mc_hom_tpu
        >>> sweep = default_session().explore_granularity(
        ...     squeezenet(), mc_hom_tpu(),
        ...     granularities=["layer", ("tile", 32, 1)],
        ...     pop_size=4, generations=2)
        >>> sorted(sweep.results), sweep.best_label in sweep.results
        (['layer', 'tile32x1'], True)
        >>> sweep.best is sweep.results[sweep.best_label]
        True
    """

    results: dict[str, StreamResult]   # granularity label -> full result
    objective: str
    best_label: str

    @property
    def best(self) -> StreamResult:
        return self.results[self.best_label]

    def items(self):
        return self.results.items()


@dataclasses.dataclass
class SweepResult:
    """Outcome of `ExplorationSession.run`: records in walk order plus
    scheduling accounting (how many points actually ran vs store hits,
    warm-start hits, and why the sweep stopped, if a policy fired).

    `best`/`pareto`/`pivot` delegate to the module-level query helpers
    over this sweep's records; see the `ExplorationSession` doctest for an
    end-to-end example.

        >>> sweep = SweepResult(records=_demo_records(), n_scheduled=3,
        ...                     n_from_store=0, wall_s=0.0, n_warm_started=1)
        >>> sweep.best("edp").key, len(sweep)
        ('a', 3)
        >>> [r.key for r in sweep.pareto()]
        ['a', 'b']
        >>> round(sweep.warm_start_hit_rate, 2), sweep.stop_reason
        (0.33, None)
        >>> sweep.n_failed, sweep.n_retried, sweep.failures  # fault-free run
        (0, 0, [])
    """

    records: list[ExplorationRecord]
    n_scheduled: int
    n_from_store: int
    wall_s: float
    n_warm_started: int = 0   # scheduled points whose GA got >=1 warm seed
    n_cancelled: int = 0      # planned points never delivered (early stop)
    stop_reason: str | None = None   # the firing StopPolicy's reason
    n_failed: int = 0         # points quarantined after exhausting retries
    n_retried: int = 0        # extra attempts burned recovering faults
    failures: list = dataclasses.field(default_factory=list)  # FailureRecord

    @property
    def warm_start_hit_rate(self) -> float:
        """Fraction of scheduled points whose GA was seeded from the store
        (0.0 when nothing was scheduled or warm starts were off)."""
        return self.n_warm_started / self.n_scheduled if self.n_scheduled \
            else 0.0

    def best(self, metric: str = "edp") -> ExplorationRecord:
        return best_record(self.records, metric)

    def pareto(self, metrics: Sequence[str] = ("latency_cc", "energy_pj"),
               ) -> list[ExplorationRecord]:
        return pareto_records(self.records, metrics)

    def pivot(self, rows: str = "arch", cols: str = "workload",
              value: str = "edp", agg=min) -> dict[str, dict[str, float]]:
        return pivot_records(self.records, rows, cols, value, agg)

    def __len__(self) -> int:
        return len(self.records)


class ResultStore:
    """Content-keyed persistent record store (JSONL, append-only).

    With a `cache_dir` every record is appended to `records.jsonl` as it
    arrives and reloaded on construction (last write wins), making repeated
    sweeps incremental across processes and sessions; with `cache_dir=None`
    the store is memory-only and lives as long as the session.  A
    `cache_dir` ending in ``.jsonl`` is taken as the store file itself
    (shard stores are often addressed by file).

    Crash safety: appends are single `O_APPEND` writes under an advisory
    `fcntl` lock, so concurrent shard writers cannot interleave torn
    lines.  On load, only a malformed *final* line — the signature of a
    crash mid-append — is silently dropped (and truncated away so later
    appends start on a clean line); a malformed line anywhere earlier
    raises `StoreCorruptionError` unless the store is opened with
    ``repair=True``, which quarantines the bad lines to a ``.bad``
    sidecar and warns with counts.  Quarantined point failures
    (`FailureRecord`) live in a ``failures.jsonl`` sidecar beside the
    records; a failure is superseded the moment a healthy record for the
    same key lands.

        >>> store = ResultStore()                   # memory-only
        >>> rec = _demo_records()[0]
        >>> store.put(rec)
        >>> store.get("a") == rec, "a" in store, len(store)
        (True, True, 1)
        >>> [r.key for r in store.for_workload("w")]
        ['a']
    """

    FILENAME = "records.jsonl"
    FAILURES_FILENAME = "failures.jsonl"

    @staticmethod
    def resolve_path(store: str) -> str:
        """The ``records.jsonl`` location behind a store address — either a
        ``.jsonl`` file path (used verbatim) or a store directory.

            >>> ResultStore.resolve_path("shard0")
            'shard0/records.jsonl'
            >>> ResultStore.resolve_path("direct/recs.jsonl")
            'direct/recs.jsonl'
        """
        store = str(store)
        return store if store.endswith(".jsonl") \
            else os.path.join(store, ResultStore.FILENAME)

    @staticmethod
    def resolve_failures_path(store: str) -> str:
        """The failures sidecar beside a store address.

            >>> ResultStore.resolve_failures_path("shard0")
            'shard0/failures.jsonl'
            >>> ResultStore.resolve_failures_path("direct/recs.jsonl")
            'direct/recs.failures.jsonl'
        """
        path = ResultStore.resolve_path(store)
        if os.path.basename(path) == ResultStore.FILENAME:
            return os.path.join(os.path.dirname(path),
                                ResultStore.FAILURES_FILENAME)
        return path[:-len(".jsonl")] + ".failures.jsonl"

    def __init__(self, cache_dir: str | None = None, repair: bool = False):
        self._records: dict[str, ExplorationRecord] = {}
        # per-workload view of the same records (warm-start lookups are
        # per workload; scanning the whole store per point is O(sweep^2))
        self._by_workload: dict[str, dict[str, ExplorationRecord]] = {}
        self._failures: dict[str, FailureRecord] = {}
        self.path: str | None = None
        self.failures_path: str | None = None
        if cache_dir is not None:
            self.path = self.resolve_path(cache_dir)
            self.failures_path = self.resolve_failures_path(cache_dir)
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            if os.path.exists(self.path):
                for rec in self._load_jsonl(
                        self.path, ExplorationRecord.from_dict, repair):
                    self._records[rec.key] = rec
                    self._by_workload.setdefault(
                        rec.workload, {})[rec.key] = rec
            if os.path.exists(self.failures_path):
                for f in self._load_jsonl(
                        self.failures_path, FailureRecord.from_dict, repair):
                    if f.key not in self._records:  # healthy record wins
                        self._failures[f.key] = f

    # ---- crash-safe JSONL plumbing ---------------------------------------
    @staticmethod
    def _scan_jsonl(path: str, parse):
        """Parse a JSONL file, classifying lines.

        Returns ``(parsed, bad, offsets, n_lines)`` where `parsed` is
        ``[(index, object), ...]``, `bad` is ``[(index, raw_line), ...]``
        and `offsets[i]` is the byte offset of line `i` (for tail
        truncation)."""
        with open(path, encoding="utf-8") as f:
            raw = f.read()
        lines = raw.split("\n")
        if lines and lines[-1] == "":
            lines.pop()                # trailing newline, not an entry
        parsed, bad, offsets, pos = [], [], [], 0
        for i, line in enumerate(lines):
            offsets.append(pos)
            pos += len(line.encode("utf-8")) + 1
            if not line.strip():
                continue
            try:
                parsed.append((i, parse(json.loads(line))))
            except (ValueError, KeyError, TypeError):
                bad.append((i, line))
        return parsed, bad, offsets, len(lines)

    @classmethod
    def _load_jsonl(cls, path: str, parse, repair: bool) -> list:
        """Strict JSONL load: only a torn *tail* may vanish silently.

        A malformed final line is the expected signature of a crash
        mid-append: it is dropped and the file truncated back to the last
        good line (so the next append starts clean instead of gluing onto
        the torn bytes).  Malformed lines anywhere earlier are corruption:
        `StoreCorruptionError` unless `repair`, which moves them to
        ``<path>.bad`` and rewrites the file, warning with counts."""
        parsed, bad, offsets, n_lines = cls._scan_jsonl(path, parse)
        torn = None
        if bad and bad[-1][0] == n_lines - 1:
            torn = bad.pop()           # torn tail: silently dropped
        if bad:
            if not repair:
                raise StoreCorruptionError(
                    f"{path}: {len(bad)} malformed line(s) before the final "
                    f"line (first at line {bad[0][0] + 1}) — refusing to "
                    "silently drop records; open with repair=True to "
                    f"quarantine them to {path}.bad")
            quarantined = bad + ([torn] if torn is not None else [])
            with open(path + ".bad", "a", encoding="utf-8") as bf:
                for _, line in quarantined:
                    bf.write(line + "\n")
            good = {i for i, _ in parsed}
            with open(path, encoding="utf-8") as f:
                lines = f.read().split("\n")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for i, _ in parsed:
                    f.write(lines[i] + "\n")
            os.replace(tmp, path)
            warnings.warn(
                f"{path}: quarantined {len(quarantined)} malformed line(s) "
                f"to {path}.bad ({len(good)} good records kept)",
                RuntimeWarning, stacklevel=3)
        elif torn is not None:
            try:                       # truncate the torn tail away
                with open(path, "r+", encoding="utf-8") as f:
                    f.truncate(offsets[torn[0]])
            except OSError:            # read-only store: load-only repair
                pass
        return [obj for _, obj in parsed]

    def _append(self, path: str, data: str) -> None:
        """Single locked `O_APPEND` write — two shards pointed at one
        store file cannot interleave torn lines."""
        fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            if fcntl is not None:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX)
                except OSError as e:
                    raise StoreLockError(
                        f"cannot take the advisory lock on {path}: {e} "
                        "(refusing an unlocked append — another writer "
                        "could interleave torn lines)") from e
            os.write(fd, data.encode("utf-8"))
        finally:
            os.close(fd)               # closing releases the flock

    def repair_tail(self) -> int:
        """Truncate a torn (newline-less) tail; returns bytes removed.

        The recovery step after a crash-mid-append (or an injected
        ``corrupt`` fault): the file ends without a newline exactly when
        an append died partway, and everything after the last newline is
        the torn fragment."""
        if self.path is None or not os.path.exists(self.path):
            return 0
        with open(self.path, "rb+") as f:
            data = f.read()
            if not data or data.endswith(b"\n"):
                return 0
            cut = data.rfind(b"\n") + 1
            f.truncate(cut)
            return len(data) - cut

    def append_torn(self, text: str) -> None:
        """Append a torn (truncated, newline-less) line — the fault
        injector's model of a crash mid-append.  Test/injection only."""
        if self.path is not None:
            self._append(self.path, text[: max(1, len(text) // 2)])

    def verify(self) -> dict:
        """Integrity-check the on-disk store files.

        Returns ``{"n_records", "n_failures", "torn_tail"}`` counts on
        success; raises `StoreCorruptionError` if either file has
        malformed lines before its final line.  Exposed on the CLI as
        ``tools/merge_stores.py --verify`` (via `verify_path`, which
        checks a store address without loading it)."""
        return self._verify_files(self.path, self.failures_path)

    @classmethod
    def verify_path(cls, store: str) -> dict:
        """`verify()` for a store address (directory or ``.jsonl`` file)
        without loading it — so corruption is a report, not a load error."""
        return cls._verify_files(cls.resolve_path(store),
                                 cls.resolve_failures_path(store))

    @classmethod
    def _verify_files(cls, records_path: str | None,
                      failures_path: str | None) -> dict:
        report = {"n_records": 0, "n_failures": 0, "torn_tail": 0}
        for path, parse, field in (
                (records_path, ExplorationRecord.from_dict, "n_records"),
                (failures_path, FailureRecord.from_dict, "n_failures")):
            if path is None or not os.path.exists(path):
                continue
            parsed, bad, _, n_lines = cls._scan_jsonl(path, parse)
            if bad and bad[-1][0] == n_lines - 1:
                bad.pop()
                report["torn_tail"] += 1
            if bad:
                raise StoreCorruptionError(
                    f"{path}: {len(bad)} malformed line(s) before the final "
                    f"line (first at line {bad[0][0] + 1})")
            report[field] = len(parsed)
        return report

    # ---- records ---------------------------------------------------------
    def get(self, key: str) -> ExplorationRecord | None:
        return self._records.get(key)

    def put(self, record: ExplorationRecord) -> None:
        self._records[record.key] = record
        self._by_workload.setdefault(record.workload, {})[record.key] = record
        self._failures.pop(record.key, None)   # success supersedes failure
        if self.path is not None:
            self._append(self.path, json.dumps(record.to_dict()) + "\n")

    def values(self) -> list[ExplorationRecord]:
        return list(self._records.values())

    def for_workload(self, workload: str) -> list[ExplorationRecord]:
        """Records of one workload (the warm-start candidate pool)."""
        return list(self._by_workload.get(workload, {}).values())

    def __len__(self) -> int:
        return len(self._records)

    def __contains__(self, key: str) -> bool:
        return key in self._records

    # ---- quarantined failures --------------------------------------------
    def put_failure(self, failure: FailureRecord) -> None:
        """Quarantine a point that exhausted its retry budget.

        A no-op when a healthy record for the key already exists (the
        failure is stale by definition)."""
        if failure.key in self._records:
            return
        self._failures[failure.key] = failure
        if self.failures_path is not None:
            self._append(self.failures_path,
                         json.dumps(failure.to_dict()) + "\n")

    def get_failure(self, key: str) -> FailureRecord | None:
        return self._failures.get(key)

    def failures(self) -> list[FailureRecord]:
        """Quarantined points without a healthy record (insertion order)."""
        return list(self._failures.values())

    @classmethod
    def merge(cls, *stores: "ResultStore | str", cache_dir: str | None = None,
              repair: bool = False) -> "ResultStore":
        """Concatenate stores, deduplicating by content key (first wins).

        Records are content-keyed — identical keys promise identical
        metrics — so merging is pure concatenation + dedup: the N-shard
        output of a partitioned sweep merges into exactly the serial run's
        record set.  The merge is idempotent (re-merging a shard adds
        nothing) and commutative as a record set.  Sources may be
        `ResultStore`s or paths (directories holding ``records.jsonl``, or
        ``.jsonl`` files directly) — a path without a store file is a
        `FileNotFoundError`, never a silently empty contribution;
        `cache_dir` persists the merged store.

        Failure records fold the same way — first wins per key — except
        that a healthy record for a key from *any* source supersedes every
        shard's failure for it, so the healthy-point merge is exactly the
        fault-free record set and only genuinely unrecovered points stay
        quarantined.

            >>> a, b = ResultStore(), ResultStore()
            >>> r0, r1, _ = _demo_records()
            >>> a.put(r0), b.put(r0), b.put(r1)     # r0 lands in both
            (None, None, None)
            >>> sorted(r.key for r in ResultStore.merge(a, b).values())
            ['a', 'b']
            >>> len(ResultStore.merge(a, b, b)) == len(ResultStore.merge(b, a))
            True
        """
        for src in stores:
            # a shard whose every point was quarantined has only the
            # failures sidecar — still a store, still worth merging
            if not isinstance(src, ResultStore) \
                    and not os.path.exists(cls.resolve_path(src)) \
                    and not os.path.exists(cls.resolve_failures_path(src)):
                raise FileNotFoundError(
                    f"no shard store at {cls.resolve_path(src)}")
        loaded = [src if isinstance(src, ResultStore)
                  else cls(str(src), repair=repair) for src in stores]
        out = cls(cache_dir)
        for src in loaded:
            for rec in src.values():
                if rec.key not in out:
                    out.put(dataclasses.replace(rec, from_store=False))
        for src in loaded:
            for failure in src.failures():
                if failure.key not in out._failures:
                    out.put_failure(failure)   # healthy keys skipped inside
        return out


# ---------------------------------------------------------------------------
# process-pool worker: rebuilds engines from the picklable point spec in a
# process-local session (caches warm up per worker, results return as dicts)
# ---------------------------------------------------------------------------
_WORKER_SESSION: "ExplorationSession | None" = None


def _process_worker(job: tuple) -> dict:
    """Compute one point (with worker-side retries) and return the
    `PointOutcome` envelope as a JSON-able dict.

    Exceptions — real or injected — are retried here, inside the worker,
    up to the shipped `RetryPolicy` budget; only worker *kills* (abrupt
    process death) need the parent's pool-rebuild path."""
    global _WORKER_SESSION
    if _WORKER_SESSION is None:
        _WORKER_SESSION = ExplorationSession()
    point, warm, start_attempt, retry_policy, injector = job
    outcome = _WORKER_SESSION._compute_outcome(
        point,
        initial_allocations=[np.array(a, dtype=np.int64) for a in warm],
        retry_policy=retry_policy, fault_injector=injector,
        start_attempt=start_attempt, allow_kill=True)
    return outcome.to_jsonable()


# ---------------------------------------------------------------------------
# sweep executors: the protocol shared by the serial, process-pool, and shard
# backends (`repro_torch.api.distributed` runs shards through these same classes)
# ---------------------------------------------------------------------------

class SweepExecutor:
    """Backend protocol of `ExplorationSession.run`/`run_async`.

    `stream(points, warm_lookup)` yields exactly one `PointOutcome`
    per point **in submission order** — the determinism contract that makes
    streamed sweeps, early stops, and shard merges reproduce the serial
    record sequence bit-for-bit regardless of how the work was overlapped.
    An outcome carries either a healthy `ExplorationRecord` or, when the
    point exhausted its retry budget, a `FailureRecord` — executors never
    let one bad point abort the sweep.  `cancel()` drops everything not
    yet yielded (outstanding work may still burn cycles, but its records
    never land in the store)."""

    def stream(self, points: "Sequence[DesignPoint]",
               warm_lookup: Callable[["DesignPoint"], Sequence],
               ) -> Iterator[PointOutcome]:
        raise NotImplementedError

    def cancel(self) -> None:  # pragma: no cover - overridden or no-op
        pass


class SerialExecutor(SweepExecutor):
    """In-process backend: computes each point when the consumer pulls it.

    Warm starts are resolved lazily, point by point, so later points in one
    sweep see the records of earlier ones (the behavior the nearest-arch
    walk is designed around).  Per-point exceptions are retried under the
    session's `RetryPolicy` and quarantined on exhaustion — they never
    propagate out of the stream.

        >>> from repro_torch.api.designspace import DesignSpace, GAConfig
        >>> from repro_torch.hw.catalog import sc_tpu
        >>> space = DesignSpace(workloads=["fsrcnn"], archs={"SC:TPU": sc_tpu},
        ...                     granularities=["layer"],
        ...                     ga=GAConfig(pop_size=4, generations=2))
        >>> ex = SerialExecutor(ExplorationSession())
        >>> [o.record.granularity for o in ex.stream(list(space),
        ...                                          lambda p: ())]
        ['layer']
    """

    def __init__(self, session: "ExplorationSession"):
        self.session = session
        self._cancelled = False

    def stream(self, points, warm_lookup):
        self._cancelled = False     # re-arm: executors are reusable
        for point in points:
            if self._cancelled:
                return
            yield self.session._compute_outcome(
                point, initial_allocations=warm_lookup(point))

    def cancel(self) -> None:
        self._cancelled = True


class _PoolJob:
    """Parent-side state of one submitted point (attempt/retry ledger)."""

    __slots__ = ("point", "warm", "key", "attempt", "n_retries", "outcome")

    def __init__(self, point, warm, attempt=0):
        self.point = point
        self.warm = warm
        self.key = point.content_key()
        self.attempt = attempt          # attempts burned so far
        self.n_retries = 0              # parent-side retries (kills/timeouts)
        self.outcome: PointOutcome | None = None   # set when pre-resolved


class ProcessExecutor(SweepExecutor):
    """Spawn-based process-pool backend.

    All points are submitted up-front (warm starts therefore resolve
    against the pre-existing store only — workers have no store) and
    outcomes are yielded in submission order, so the stream is
    bit-identical to `SerialExecutor`'s while computation overlaps across
    workers.  `cancel()` abandons unfinished futures; their results are
    discarded even if a worker was already computing them, keeping the
    ingested record set deterministic at record granularity.

    Fault tolerance: per-point exceptions retry *inside* the worker under
    `retry_policy`; a worker that dies abruptly (SIGKILL, injected kill)
    breaks the whole pool, and the executor survives it — the spawn pool
    is rebuilt and every un-yielded point resubmitted.  Attribution is
    deterministic under an injected schedule (the parent holds the same
    pure `FaultInjector` and charges exactly the points planned to die);
    for real, unplanned deaths the head point — the one whose result was
    being awaited — is charged.  `deadline_s` bounds each `future.result`
    wait: a straggler past the deadline is re-dispatched as a fresh
    attempt (wall-clock-based, so a robustness net rather than a
    reproducibility boundary — like `BudgetPolicy.max_wall_s`)."""

    def __init__(self, max_workers: int | None = None,
                 retry_policy: RetryPolicy | None = None,
                 fault_injector: FaultInjector | None = None,
                 deadline_s: float | None = None):
        self.max_workers = max_workers or os.cpu_count() or 1
        self.retry_policy = retry_policy
        self.fault_injector = fault_injector
        self.deadline_s = deadline_s
        self._pool: ProcessPoolExecutor | None = None
        self._cancelled = False

    # spawn, not fork: callers routinely have jax (multithreaded)
    # imported, and forking a threaded process can deadlock; a parent that
    # holds a CUDA context must never fork either
    def _new_pool(self) -> ProcessPoolExecutor:
        return ProcessPoolExecutor(
            max_workers=self.max_workers,
            mp_context=multiprocessing.get_context("spawn"))

    def _submit(self, job: _PoolJob):
        return self._pool.submit(
            _process_worker, (job.point, job.warm, job.attempt,
                              self.retry_policy, self.fault_injector))

    def _planned_death(self, job: _PoolJob,
                       policy: RetryPolicy) -> "int | None":
        """The attempt at which `job` was scheduled to kill its worker,
        walking the injector's pure plan through worker-side exception
        retries; None when the job was not doomed to die."""
        if self.fault_injector is None:
            return None
        attempt = job.attempt
        while attempt < policy.max_attempts:
            kind = self.fault_injector.plan(job.key, attempt)
            if kind == "kill":
                return attempt
            if kind == "exception":    # the worker retries these locally
                attempt += 1
                continue
            return None                # clean attempt (or a mere delay)
        return None

    def _fail(self, job: _PoolJob, error_type: str,
              message: str) -> PointOutcome:
        return PointOutcome(
            key=job.key, n_retries=job.n_retries,
            failure=FailureRecord(
                key=job.key, workload=job.point.workload_name,
                arch=job.point.arch.name, error_type=error_type,
                message=message, traceback="", attempts=job.attempt,
                spec=job.point.spec_dict()))

    def _charge(self, job: _PoolJob, policy: RetryPolicy, new_attempt: int,
                error_type: str, message: str) -> None:
        """Burn attempts on `job` up to `new_attempt`; quarantine it when
        the budget is gone, otherwise mark the parent-side retry."""
        burned = new_attempt - job.attempt
        job.attempt = new_attempt
        if job.attempt >= policy.max_attempts:
            job.outcome = self._fail(job, error_type, message)
        else:
            job.n_retries += burned

    def _rebuild(self, jobs: "list[_PoolJob]", futures: dict, head: int,
                 policy: RetryPolicy) -> None:
        """Survive `BrokenProcessPool`: rebuild the spawn pool and
        resubmit every un-yielded, un-finished point."""
        old = self._pool
        self._pool = self._new_pool()
        old.shutdown(wait=False, cancel_futures=True)
        blamed = 0
        for j in range(head, len(jobs)):
            job = jobs[j]
            if job.outcome is not None:
                continue
            died_at = self._planned_death(job, policy)
            if died_at is not None:
                blamed += 1
                self._charge(job, policy, died_at + 1, "WorkerKilled",
                             f"worker process died (injected kill at "
                             f"attempt {died_at})")
        if blamed == 0:
            # real, unplanned death: attribution is unknowable, so charge
            # the head point (whose result we were awaiting)
            self._charge(jobs[head], policy, jobs[head].attempt + 1,
                         "BrokenProcessPool",
                         "worker process died abruptly")
        for j in range(head, len(jobs)):
            job = jobs[j]
            if job.outcome is not None:
                continue
            fut = futures.get(j)
            if fut is not None and fut.done() and not fut.cancelled() \
                    and fut.exception() is None:
                continue               # its result survived the pool break
            futures[j] = self._submit(job)

    def stream(self, points, warm_lookup):
        self._cancelled = False     # re-arm: executors are reusable
        self._pool = None
        if not points:
            return
        policy = self.retry_policy or NO_RETRY
        jobs = [_PoolJob(p, tuple(tuple(int(x) for x in a)
                                  for a in warm_lookup(p))) for p in points]
        self._pool = self._new_pool()
        futures: dict[int, object] = {}
        try:
            for i, job in enumerate(jobs):
                futures[i] = self._submit(job)
            i = 0
            while i < len(jobs):
                if self._cancelled:
                    return
                job = jobs[i]
                if job.outcome is not None:    # resolved during a rebuild
                    yield job.outcome
                    i += 1
                    continue
                try:
                    env = futures[i].result(timeout=self.deadline_s)
                except _FutureTimeout:
                    # straggler: re-dispatch as a fresh attempt; the old
                    # future's result, if it ever lands, is ignored
                    self._charge(job, policy, job.attempt + 1,
                                 "DeadlineExceeded",
                                 f"no result within {self.deadline_s:g}s")
                    if job.outcome is None:
                        futures[i] = self._submit(job)
                    continue
                except BrokenProcessPool:
                    self._rebuild(jobs, futures, i, policy)
                    continue
                except Exception as e:  # infrastructure failure (pickling,
                    # worker teardown, ...): quarantine, don't abort
                    self._charge(job, policy, policy.max_attempts,
                                 type(e).__name__, str(e))
                    yield job.outcome
                    i += 1
                    continue
                outcome = PointOutcome.from_jsonable(env)
                outcome.n_retries += job.n_retries
                yield outcome
                i += 1
        finally:
            self._pool.shutdown(wait=not self._cancelled,
                                cancel_futures=self._cancelled)

    def cancel(self) -> None:
        self._cancelled = True
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)


@dataclasses.dataclass
class _SweepState:
    """Shared accounting between a sweep's record stream and its summary."""

    todo: list
    planned_store_hits: int          # store hits in the walk plan
    store_hits: int = 0              # store hits actually delivered
    n_computed: int = 0
    n_warm_started: int = 0
    n_failed: int = 0                # points quarantined this sweep
    n_retried: int = 0               # extra attempts burned on recovery
    failures: list = dataclasses.field(default_factory=list)
    stop_reason: str | None = None


# sentinel marking a walk key whose point was quarantined (duplicate walk
# positions for the key must not pull another outcome from the executor)
_QUARANTINED = object()


class ExplorationSession:
    """Owns exploration state: graph/engine caches, the result store, and
    the executors that walk a `DesignSpace`.

    The one-call pipeline (`explore`) and the sweep pipeline (`run`) share
    the same memoized graph/engine builds; `run` additionally serves
    repeated points from the content-keyed store without scheduling.

        >>> from repro_torch.api.designspace import DesignSpace, GAConfig
        >>> from repro_torch.configs.paper_workloads import squeezenet
        >>> from repro_torch.hw.catalog import mc_hom_tpu
        >>> space = DesignSpace(workloads=["squeezenet"],
        ...                     archs={"MC:HomTPU": mc_hom_tpu},
        ...                     granularities=[("tile", 32, 1)],
        ...                     ga=GAConfig(pop_size=4, generations=2))
        >>> session = ExplorationSession()          # memory-only store
        >>> sweep = session.run(space)
        >>> len(sweep), sweep.n_scheduled, sweep.best("edp").arch
        (1, 1, 'MC:HomTPU')
        >>> session.run(space).n_from_store         # re-run: zero new points
        1
    """

    def __init__(self, cache_dir: str | None = None, cache_limit: int = 32,
                 max_workers: int | None = None, warm_start: bool = False,
                 retry_policy: RetryPolicy | None = None,
                 fault_injector: FaultInjector | None = None,
                 deadline_s: float | None = None, repair: bool = False,
                 prefilter: bool = False, prefilter_keep: float = 0.75,
                 tracer=None, device=None):
        self._graphs = FifoCache(cache_limit)
        # evicted engines fold their checkpoint counters into a session
        # total, so `checkpoint_stats()` covers the whole session lifetime
        # and not just the engines still resident in the FIFO
        self._ckpt_evicted: dict[str, int] = {}
        self._engines = FifoCache(cache_limit, on_evict=self._fold_ckpt_stats)
        self.store = ResultStore(cache_dir, repair=repair)
        self.max_workers = max_workers
        # warm_start seeds each point's GA from the best stored allocations
        # of neighboring points. Off by default: warm-started results depend
        # on store contents, so they are no longer a pure function of the
        # point's content key (records carry `ga_warm_starts` for auditing).
        self.warm_start = warm_start
        # resilience: per-point exceptions are retried under `retry_policy`
        # (seeded deterministic backoff) and quarantined as FailureRecords
        # on exhaustion — a fault degrades the sweep, never aborts it.
        # `fault_injector` (tests/benches) injects a seeded fault schedule;
        # `deadline_s` bounds each process-executor result wait.
        self.retry_policy = retry_policy
        self.fault_injector = fault_injector
        self.deadline_s = deadline_s
        # vectorized GA prefilter (repro_torch.core.vectorized.BatchedFitness):
        # rank each generation's novel offspring approximately and prune the
        # worst before exact rescoring. Off by default — approximate ranks
        # can steer the GA's search trajectory, so prefiltered runs are only
        # committed where their metrics are verified unchanged.
        self.prefilter = prefilter
        self.prefilter_keep = prefilter_keep
        # optional sim-time tracer (repro_torch.obs.Tracer): threaded into the
        # schedule engine / GA of every explore() and counted against each
        # sweep's computed/store-hit/retry/quarantine events.  None by
        # default — the instrumented paths pay one branch, nothing else,
        # and results are bit-identical either way.  Worker subprocesses
        # never see it (fresh sessions are built inside workers).
        self.tracer = tracer
        # where the prefilter's batched fitness runs (None: CUDA); resolved
        # when the fitness is built, so a session that never prefilters
        # needs no device.  Not part of any record or content key.
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
    @staticmethod
    def _materialize(arch: "ArchSpec | Accelerator") -> Accelerator:
        return arch.to_accelerator() if isinstance(arch, ArchSpec) else arch

    def graph(self, workload: Workload, arch: "ArchSpec | Accelerator",
              granularity, use_rtree: bool = True) -> CNGraph:
        """CN graph for (workload content, granularity, HW min tiles)."""
        accelerator = self._materialize(arch)
        min_tile = hw_min_tiles(accelerator)
        key = (_graph_key(workload, granularity, min_tile), use_rtree)
        graph = self._graphs.get(key)
        if graph is None:
            cns = identify_cns(workload, granularity, min_tile)
            graph = build_cn_graph(workload, cns, use_rtree=use_rtree)
            self._graphs.put(key, graph)
        return graph

    def engine(self, workload: Workload, arch: "ArchSpec | Accelerator",
               granularity) -> ScheduleEngine:
        """Precomputed schedule engine (CSR graph + dense cost tables)."""
        accelerator = self._materialize(arch)
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
        arch: "ArchSpec | Accelerator",
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
        accelerator = self._materialize(arch)
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
        arch: "ArchSpec | Accelerator",
        allocation,
        granularity="line",
        priority: str = "latency",
        graph: CNGraph | None = None,
        engine: ScheduleEngine | None = None,
    ) -> ScheduleResult:
        """Schedule a fixed layer-core allocation (validation benches)."""
        accelerator = self._materialize(arch)
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
        arch: "ArchSpec | Accelerator",
        allocations,
        granularity="line",
        priority: str = "latency",
    ) -> np.ndarray:
        """(P, 2) [latency_cc, energy_pj] for a (P, G) allocation matrix.

        The population-batched fitness path: one shared engine per
        (graph, arch) pair, with segment-prefix checkpoints reused across
        the whole batch (and across calls — the store lives on the engine)."""
        engine = self.engine(workload, self._materialize(arch), granularity)
        return engine.evaluate_population(
            allocations, priority, strict_layers=(granularity == "layer"))

    def _fold_ckpt_stats(self, entry) -> None:
        _, engine = entry
        for k, v in engine.ckpt_stats.items():
            self._ckpt_evicted[k] = self._ckpt_evicted.get(k, 0) + v
            # zero (keep the snapshot store): the engine may re-enter this
            # cache via the graph-level engine cache — its future work must
            # not re-count the folded history
            engine.ckpt_stats[k] = 0

    def checkpoint_stats(self) -> dict[str, int]:
        """Segment-checkpoint counters over every engine this session built
        (resident + evicted). Process-executor runs schedule inside worker
        sessions, so their counters are not visible here."""
        out = dict.fromkeys(ScheduleEngine.CKPT_COUNTERS, 0)
        out.update(self._ckpt_evicted)
        for _, engine in self._engines._data.values():
            for k, v in engine.ckpt_stats.items():
                out[k] = out.get(k, 0) + v
        return out

    def metrics_snapshot(self) -> dict:
        """Operator-facing metrics of this session's current state: store
        sizes plus (when a tracer is attached) its sorted counter map —
        the payload `HeartbeatMonitor` embeds into shard heartbeats and
        `tools/sweep_top.py` renders fleet-wide.

        A pure read: calling it never mutates session, store, or tracer
        state.
        """
        snap = {"store_records": len(self.store),
                "store_failures": len(self.store.failures())}
        if self.tracer is not None:
            snap.update(self.tracer.snapshot()["counters"])
        return snap

    def explore_granularity(
        self,
        workload: Workload,
        arch: "ArchSpec | Accelerator",
        granularities=DEFAULT_GRANULARITIES,
        objective: str = "edp",
        **kw,
    ) -> GranularitySweep:
        """Co-explore scheduling granularity with allocation (paper Sec. V)."""
        results = {granularity_label(g): self.explore(
            workload, arch, granularity=g, objective=objective, **kw)
            for g in granularities}
        metric = _OBJECTIVE_METRIC[objective]
        best_label = min(results, key=lambda k: getattr(results[k], metric))
        return GranularitySweep(results=results, objective=objective,
                                best_label=best_label)

    # ---- store-backed GA warm starts -------------------------------------
    def warm_start_allocations(self, point: DesignPoint,
                               limit: int = 4) -> list[np.ndarray]:
        """Best stored allocations from neighboring points, to seed a GA.

        Neighbors are records of the *same workload* whose allocation is
        feasible on this point's architecture, ranked by architecture
        similarity (`repro_torch.api.designspace.arch_spec_similarity` — the same
        ranking that drives the `order="nearest-arch"` walk — plus matching
        granularity/priority) and then by their own objective value — the
        ROADMAP's "nearby arch in the grid" without needing an explicit
        grid: the spec distance is the grid distance. Returns at most
        `limit` distinct allocations; empty when the store has no usable
        neighbor (the GA then falls back to its random cold start)."""
        workload = point.workload
        n_layers = len(workload.layers)
        accelerator = self._materialize(point.arch)
        feas_sets = [set(f) for f in
                     feasible_cores_per_layer(workload, accelerator)]
        self_key = point.content_key()
        target_arch = point.arch.to_dict()

        def similarity(r: ExplorationRecord) -> int:
            arch = (r.spec or {}).get("arch") or {}
            s = arch_spec_similarity(arch, target_arch)
            if r.granularity == point.granularity_label:
                s += 1
            if r.priority == point.priority:
                s += 1
            return s

        cands = []
        for r in self.store.for_workload(point.workload_name):
            if len(r.allocation) != n_layers or r.key == self_key:
                continue
            if any(core not in feas_sets[lid]
                   for lid, core in enumerate(r.allocation)):
                continue
            cands.append(r)
        cands.sort(key=lambda r: (-similarity(r), r.metric(point.objective),
                                  r.key))
        out: list[np.ndarray] = []
        seen: set[tuple[int, ...]] = set()
        for r in cands:
            if r.allocation in seen:
                continue
            seen.add(r.allocation)
            out.append(np.array(r.allocation, dtype=np.int64))
            if len(out) >= limit:
                break
        return out

    # ---- sweep execution -------------------------------------------------
    def _compute_record(self, point: DesignPoint,
                        initial_allocations=()) -> ExplorationRecord:
        res = self.explore(
            point.workload, point.arch, granularity=point.granularity,
            objective=point.objective, priority=point.priority,
            pop_size=point.ga.pop_size, generations=point.ga.generations,
            seed=point.ga.seed, initial_allocations=initial_allocations)
        return ExplorationRecord(
            key=point.content_key(), workload=point.workload_name,
            arch=point.arch.name, arch_key=point.arch.content_key(),
            granularity=point.granularity_label, objective=point.objective,
            priority=point.priority, latency_cc=float(res.latency_cc),
            energy_pj=float(res.energy_pj), edp=float(res.edp),
            peak_mem_bytes=float(res.peak_mem_bytes),
            act_peak_bytes=float(res.schedule.act_peak_bytes),
            allocation=tuple(int(x) for x in res.allocation),
            ga_evaluations=res.ga.evaluations if res.ga is not None else 0,
            runtime_s=res.runtime_s,
            energy_breakdown={k: float(v) for k, v in
                              res.schedule.energy_breakdown.items()},
            spec=point.spec_dict(),
            ga_warm_starts=len(initial_allocations))

    def _compute_outcome(self, point: DesignPoint, initial_allocations=(),
                         retry_policy: RetryPolicy | None = None,
                         fault_injector: FaultInjector | None = None,
                         start_attempt: int = 0,
                         allow_kill: bool = False) -> PointOutcome:
        """`_compute_record` wrapped in the retry/quarantine loop.

        Exceptions — injected or real — burn attempts against the
        `RetryPolicy` budget (defaulting to the session's), sleeping the
        policy's seeded deterministic backoff between tries; a point that
        exhausts the budget returns a `FailureRecord` outcome instead of
        raising, so one bad point degrades the sweep without aborting it.
        `allow_kill` lets injected kill faults actually SIGKILL the
        process (pool workers only)."""
        policy = retry_policy or self.retry_policy or NO_RETRY
        injector = fault_injector if fault_injector is not None \
            else self.fault_injector
        key = point.content_key()
        attempt, n_retries = start_attempt, 0
        while True:
            try:
                if injector is not None:
                    injector.fire(key, attempt, allow_kill=allow_kill)
                record = self._compute_record(
                    point, initial_allocations=initial_allocations)
                return PointOutcome(key=key, record=record,
                                    n_retries=n_retries)
            except Exception as exc:
                attempt += 1
                if not policy.should_retry(attempt):
                    return PointOutcome(
                        key=key, n_retries=n_retries,
                        failure=FailureRecord.from_exception(
                            point, exc, attempts=attempt))
                n_retries += 1
                delay = policy.delay_s(key, attempt)
                if delay > 0:
                    time.sleep(delay)

    def _store_put_resilient(
            self, record: ExplorationRecord,
    ) -> "tuple[FailureRecord | None, int]":
        """Persist a record, surviving injected store-corruption faults.

        A planned ``corrupt`` fault tears the append mid-line (the crash
        model) — recovery truncates the torn tail and retries the write
        under the retry budget.  Returns ``(failure, n_retries)``; the
        failure is None on success."""
        injector, policy = self.fault_injector, self.retry_policy or NO_RETRY
        if injector is None or self.store.path is None:
            self.store.put(record)
            return None, 0
        attempt, n_retries = 0, 0
        while True:
            if injector.plan_corrupt(record.key, attempt):
                self.store.append_torn(json.dumps(record.to_dict()) + "\n")
                attempt += 1
                if not policy.should_retry(attempt):
                    return FailureRecord(
                        key=record.key, workload=record.workload,
                        arch=record.arch, error_type="StoreCorruption",
                        message="store append torn by injected corruption "
                                "and retry budget exhausted",
                        traceback="", attempts=attempt,
                        spec=record.spec), n_retries
                n_retries += 1
                self.store.repair_tail()
                continue
            self.store.put(record)
            return None, n_retries

    def _make_executor(self, executor: "str | SweepExecutor",
                       max_workers: int | None) -> SweepExecutor:
        if isinstance(executor, SweepExecutor):
            return executor
        if executor == "serial":
            return SerialExecutor(self)
        if executor == "process":
            return ProcessExecutor(max_workers or self.max_workers,
                                   retry_policy=self.retry_policy,
                                   fault_injector=self.fault_injector,
                                   deadline_s=self.deadline_s)
        raise ValueError(f"unknown executor {executor!r} "
                         "(expected 'serial' or 'process')")

    def _start_sweep(self, space, executor, max_workers, warm_start, order,
                     policies, progress,
                     ) -> "tuple[_SweepState, Iterator[ExplorationRecord]]":
        """Build the walk order, split store hits from new work, and return
        the (accounting, record stream) pair `run`/`run_async` share."""
        points = order_points(space, order)
        walk: list[str] = []
        served: dict[str, ExplorationRecord] = {}
        todo: list[DesignPoint] = []
        queued: set[str] = set()
        store_hits = 0
        for p in points:
            key = p.content_key()
            walk.append(key)
            if key in served or key in queued:
                continue  # duplicate point within this run
            hit = self.store.get(key)
            if hit is not None:
                served[key] = dataclasses.replace(hit, from_store=True)
                store_hits += 1
            else:
                todo.append(p)
                queued.add(key)
        state = _SweepState(todo=todo, planned_store_hits=store_hits)
        warm = self.warm_start if warm_start is None else warm_start
        backend = self._make_executor(executor, max_workers)
        for policy in policies:   # re-arm like the executors: policies are
            reset = getattr(policy, "reset", None)   # reusable across sweeps
            if callable(reset):
                reset()

        def warm_lookup(p: DesignPoint):
            return self.warm_start_allocations(p) if warm else ()

        def quarantine(failure: FailureRecord) -> bool:
            """Record a quarantined point; True when a policy fires on it."""
            served[failure.key] = _QUARANTINED
            state.n_failed += 1
            state.failures.append(failure)
            if self.tracer is not None:
                self.tracer.count("sweep.quarantined")
            self.store.put_failure(failure)
            for policy in policies:
                observe = getattr(policy, "update_failure", None)
                if callable(observe) and observe(failure):
                    state.stop_reason = getattr(
                        policy, "reason", None) or type(policy).__name__
                    return True
            return False

        def stream() -> Iterator[ExplorationRecord]:
            computed = backend.stream(todo, warm_lookup)
            delivered_hits: set[str] = set()
            try:
                for key in walk:
                    rec = served.get(key)
                    if rec is _QUARANTINED:
                        continue       # duplicate walk slot of a failure
                    if rec is None:
                        outcome = next(computed)
                        if outcome.key != key:  # broke submission order
                            raise RuntimeError(
                                f"executor yielded point {outcome.key} at "
                                f"walk position expecting {key}")
                        state.n_retried += outcome.n_retries
                        if outcome.failure is not None:
                            if quarantine(outcome.failure):
                                return
                            continue   # degraded, not aborted: next point
                        rec = outcome.record
                        put_failure, put_retries = \
                            self._store_put_resilient(rec)
                        state.n_retried += put_retries
                        if put_failure is not None:
                            if quarantine(put_failure):
                                return
                            continue
                        served[key] = rec
                        state.n_computed += 1
                        if self.tracer is not None:
                            self.tracer.count("sweep.computed")
                            if outcome.n_retries:
                                self.tracer.count("sweep.retries",
                                                  outcome.n_retries)
                        if rec.ga_warm_starts:
                            state.n_warm_started += 1
                        if progress is not None:
                            progress(rec)
                    elif rec.from_store and key not in delivered_hits:
                        # count store hits as they are *delivered*, so an
                        # early stop does not claim undelivered ones
                        delivered_hits.add(key)
                        state.store_hits += 1
                        if self.tracer is not None:
                            self.tracer.count("sweep.store_hits")
                    yield rec
                    for policy in policies:
                        if policy.update(rec):
                            state.stop_reason = getattr(
                                policy, "reason", None) or type(policy).__name__
                            return
            finally:
                backend.cancel()
                if hasattr(computed, "close"):
                    computed.close()

        return state, stream()

    def run(
        self,
        space: "DesignSpace | Iterable[DesignPoint]",
        executor: "str | SweepExecutor" = "serial",  # 'serial' | 'process'
        max_workers: int | None = None,
        progress: Callable[[ExplorationRecord], None] | None = None,
        warm_start: bool | None = None,
        order: str = "declared",           # 'declared' | 'nearest-arch'
        policies: Sequence = (),
    ) -> SweepResult:
        """Walk a design space; store hits are served without scheduling.

        Without warm starts, both executors produce bit-identical metrics
        for every point (the pipeline is deterministic at a fixed GA seed);
        'process' fans the *new* points out to worker processes that rebuild
        engines locally from the picklable point specs.

        `order` picks the walk: `"declared"` follows the space's enumeration
        order, `"nearest-arch"` chains architectures by spec similarity
        (records come back in walk order either way — the record *set* is
        identical).  `policies` are `repro_torch.api.policies.StopPolicy` objects
        observed after every record; the first to fire ends the sweep and
        cancels outstanding points (see `run_async` for streaming access).

        Per-point failures are never fatal: points are retried per the
        session's `retry_policy` and, once the budget is exhausted,
        quarantined as `FailureRecord`s (persisted beside the store,
        reported via `SweepResult.n_failed` / `.n_retried` / `.failures`)
        while the sweep degrades gracefully and keeps going.

        `warm_start` (default: the session's setting) seeds each point's GA
        with the best stored allocations of neighboring points. The serial
        executor looks neighbors up as points complete, so later points in
        one sweep benefit from earlier ones; the process executor resolves
        warm starts up-front from the pre-existing store (workers have no
        store) and ships them with the point.  `SweepResult.n_warm_started`
        / `.warm_start_hit_rate` report how many scheduled points actually
        got seeded."""
        # wall_s is an operator-facing wall timing, excluded from content
        # keys and store records  # staticcheck: allow(wall-clock)
        t0 = time.perf_counter()
        state, stream = self._start_sweep(space, executor, max_workers,
                                          warm_start, order, policies,
                                          progress)
        records = list(stream)
        n_cancelled = (len(state.todo) - state.n_computed - state.n_failed) \
            + (state.planned_store_hits - state.store_hits)
        return SweepResult(records=records,
                           n_scheduled=state.n_computed,
                           n_from_store=state.store_hits,
                           wall_s=time.perf_counter() - t0,  # staticcheck: allow(wall-clock)
                           n_warm_started=state.n_warm_started,
                           n_cancelled=n_cancelled,
                           stop_reason=state.stop_reason,
                           n_failed=state.n_failed,
                           n_retried=state.n_retried,
                           failures=list(state.failures))

    def run_async(
        self,
        space: "DesignSpace | Iterable[DesignPoint]",
        executor: "str | SweepExecutor" = "serial",
        max_workers: int | None = None,
        policies: Sequence = (),
        warm_start: bool | None = None,
        order: str = "declared",
        progress: Callable[[ExplorationRecord], None] | None = None,
    ) -> Iterator[ExplorationRecord]:
        """Streaming `run`: yields each `ExplorationRecord` as it lands.

        Records arrive in walk order (store hits at their walk positions,
        computed points as the executor delivers them in submission order),
        so with no policies the yielded sequence equals `run(...).records`
        bit-for-bit — while the 'process' executor still overlaps the
        computation across workers.  After each yielded record every
        `StopPolicy` in `policies` is consulted; the first to fire cancels
        all outstanding points deterministically at record granularity
        (cancelled work never reaches the store).  Closing the generator
        early (``break``) cancels the same way.

            >>> from repro_torch.api.designspace import DesignSpace, GAConfig
            >>> from repro_torch.hw.catalog import sc_tpu
            >>> space = DesignSpace(workloads=["fsrcnn"],
            ...                     archs={"SC:TPU": sc_tpu},
            ...                     granularities=["layer", ("tile", 8, 1)],
            ...                     ga=GAConfig(pop_size=4, generations=2))
            >>> stream = ExplorationSession().run_async(space)
            >>> first = next(stream)
            >>> first.granularity, first.from_store
            ('layer', False)
            >>> stream.close()                  # cancels the rest
        """
        _, stream = self._start_sweep(space, executor, max_workers,
                                      warm_start, order, policies, progress)
        return stream

    # ---- closed-loop serving sweeps ---------------------------------------
    def run_serving(
        self,
        space: "DesignSpace | Iterable[DesignPoint]",
        serving=None,
        executor: "str | SweepExecutor" = "serial",
        max_workers: int | None = None,
        order: str = "declared",
    ):
        """Sweep the serving axes: one `ServingRecord` per (point, arrival
        rate, SLO).

        Phase costs come first: every point's prefill workload — and,
        for LLM serving workloads (`repro_torch.serve.workloads`), its attached
        decode-phase workload — is scheduled through the ordinary `run`
        pipeline, so phase costs are store-cached content-keyed records
        and both executors produce bit-identical metrics.  The closed
        loop itself (`repro_torch.serve.simulator.simulate`) is then a pure
        function of those costs and the seeded arrival trace, which makes
        the whole SLO-vs-QPS curve deterministic: serial and process
        executors, or a re-run against a warm store, yield the identical
        record list.  Points whose phase scheduling was quarantined by
        the retry policy are skipped (their rows are simply absent).

        `serving` defaults to the space's own `ServingSweep`
        (``DesignSpace(serving=...)``); passing it explicitly lets one
        phase-cost store serve many load scenarios.

            >>> from repro_torch.api.designspace import (DesignSpace, GAConfig,
            ...                                    ServingSweep)
            >>> from repro_torch.hw.catalog import sc_tpu
            >>> from repro_torch.serve.workloads import transformer_phases
            >>> space = DesignSpace(
            ...     workloads={"tfm": transformer_phases(
            ...         d_model=32, n_layers=1, seq_len=8)},
            ...     archs={"SC:TPU": sc_tpu}, granularities=["layer"],
            ...     ga=GAConfig(pop_size=4, generations=2),
            ...     serving=ServingSweep(rates_rps=(100.0, 1000.0),
            ...                          slo_ms=(50.0,), n_requests=4,
            ...                          decode_tokens=4))
            >>> sweep = ExplorationSession().run_serving(space)
            >>> len(sweep), sweep.n_scheduled     # 2 rates x 1 slo; 2 phases
            (2, 2)
            >>> [r.rate_rps for r in sweep.curve("tfm", "SC:TPU")]
            [100.0, 1000.0]
        """
        from repro_torch.api.designspace import ServingSweep  # noqa: F401
        from repro_torch.serve.simulator import (PhaseCosts, ServingRecord,
                                           ServingSweepResult,
                                           serving_record_key, simulate)
        from repro_torch.serve.arrivals import poisson_trace
        from repro_torch.serve.workloads import decode_phase_of

        # wall_s is an operator-facing wall timing, excluded from content
        # keys and records  # staticcheck: allow(wall-clock)
        t0 = time.perf_counter()
        if serving is None:
            serving = getattr(space, "serving", None)
        if serving is None:
            raise ValueError(
                "no ServingSweep: pass serving=... or declare the space "
                "with DesignSpace(serving=ServingSweep(...))")
        base_points = order_points(space, order)

        # phase plan: the base (prefill) point plus, when the workload
        # carries a decode phase, a sibling point for the decode workload
        phase_points: list[DesignPoint] = []
        queued: set[str] = set()
        decode_keys: dict[str, str | None] = {}
        for p in base_points:
            decode_wl = decode_phase_of(p.workload)
            plan = [p]
            if decode_wl is not None:
                plan.append(dataclasses.replace(
                    p, workload_name=f"{p.workload_name}#decode",
                    workload=decode_wl))
                decode_keys[p.content_key()] = plan[-1].content_key()
            else:
                decode_keys[p.content_key()] = None
            for q in plan:
                key = q.content_key()
                if key not in queued:
                    queued.add(key)
                    phase_points.append(q)

        phase_sweep = self.run(phase_points, executor=executor,
                               max_workers=max_workers)
        by_key = {r.key: r for r in phase_sweep.records}

        records: list[ServingRecord] = []
        seen_rows: set[str] = set()
        for p in base_points:
            pkey = p.content_key()
            prefill_rec = by_key.get(pkey)
            if prefill_rec is None:      # quarantined phase: no curve rows
                continue
            dkey = decode_keys[pkey]
            decode_rec = by_key.get(dkey) if dkey is not None else None
            if dkey is not None and decode_rec is None:
                continue
            costs = PhaseCosts(
                prefill_cc=prefill_rec.latency_cc,
                prefill_pj=prefill_rec.energy_pj,
                decode_cc=decode_rec.latency_cc if decode_rec else 0.0,
                decode_pj=decode_rec.energy_pj if decode_rec else 0.0)
            for rate in serving.rates_rps:
                trace = poisson_trace(
                    rate, serving.n_requests, seed=serving.seed,
                    clock_hz=serving.clock_hz,
                    decode_tokens=serving.decode_tokens)
                sim = simulate(trace, costs, serving.batch_slots)
                cc_to_ms = 1e3 / serving.clock_hz
                for slo in serving.slo_ms:
                    row_key = serving_record_key(
                        pkey, dkey, rate, slo, serving.batch_slots,
                        serving.n_requests, serving.seed, serving.clock_ghz,
                        serving.decode_tokens)
                    if row_key in seen_rows:   # duplicate walk entries
                        continue
                    seen_rows.add(row_key)
                    records.append(ServingRecord(
                        key=row_key, workload=p.workload_name,
                        arch=p.arch.name, granularity=p.granularity_label,
                        priority=p.priority, rate_rps=rate, slo_ms=slo,
                        batch_slots=serving.batch_slots,
                        n_requests=serving.n_requests, seed=serving.seed,
                        clock_ghz=serving.clock_ghz,
                        p50_ms=sim.p50_latency_cc() * cc_to_ms,
                        p99_ms=sim.p99_latency_cc() * cc_to_ms,
                        mean_ms=sim.mean_latency_cc() * cc_to_ms,
                        energy_per_request_pj=sim.energy_per_request_pj(),
                        qps=sim.qps(serving.clock_hz),
                        slo_attainment=sim.slo_attainment(
                            slo * 1e-3 * serving.clock_hz),
                        prefill_cc=prefill_rec.latency_cc,
                        decode_cc=decode_rec.latency_cc if decode_rec
                        else 0.0,
                        decode_tokens=serving.decode_tokens))
        return ServingSweepResult(
            records=records, n_scheduled=phase_sweep.n_scheduled,
            n_from_store=phase_sweep.n_from_store,
            wall_s=time.perf_counter() - t0)  # staticcheck: allow(wall-clock)

    # ---- queries over everything this session has seen -------------------
    def records(self) -> list[ExplorationRecord]:
        return self.store.values()

    def best(self, metric: str = "edp",
             records: Sequence[ExplorationRecord] | None = None,
             ) -> ExplorationRecord:
        return best_record(self.records() if records is None else records,
                           metric)

    def pareto(self, metrics: Sequence[str] = ("latency_cc", "energy_pj"),
               records: Sequence[ExplorationRecord] | None = None,
               ) -> list[ExplorationRecord]:
        return pareto_records(self.records() if records is None else records,
                              metrics)

    def pivot(self, rows: str = "arch", cols: str = "workload",
              value: str = "edp", agg=min,
              records: Sequence[ExplorationRecord] | None = None,
              ) -> dict[str, dict[str, float]]:
        return pivot_records(self.records() if records is None else records,
                             rows, cols, value, agg)


# ---------------------------------------------------------------------------
# default session backing the `repro_torch.core.stream_api` compatibility wrappers
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
