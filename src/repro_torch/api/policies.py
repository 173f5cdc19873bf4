"""Early-stopping policies for streamed sweeps.

A `StopPolicy` watches the record stream of `ExplorationSession.run` /
`run_async` and decides, after every record, whether the sweep should stop.
Policies are consulted at *record granularity* — between records, never
mid-point — so a policy-stopped sweep produces a deterministic prefix of
the walk-order record sequence no matter which executor computed it, and
every record that was ingested before the stop is already in the store.

Policies are stateful, and `run`/`run_async` re-arm them with `reset()` at
sweep start, so one instance is safe to reuse across sweeps (inspect
`reason`/counters between the sweep ending and the next one starting).
They observe the *full* stream, store-served records included — a budget on
fresh scheduling work should use `BudgetPolicy(max_scheduled=...)`, which
only counts computed records.

    from repro_torch.api import PlateauPolicy
    for record in session.run_async(space, policies=[PlateauPolicy(patience=8)]):
        print(record.key, record.edp)
"""
from __future__ import annotations

import json
import os
import time
from typing import Sequence

from repro_torch.api.session import ExplorationRecord


def _demo_stream() -> list[ExplorationRecord]:
    """Records with (latency, energy) = (2,2) (3,1) (2,2) (4,4) (0.5,1) —
    EDPs 4, 3, 4, 16, 0.5 — for the policy doctests."""
    mk = lambda i, lat, e: ExplorationRecord(
        key=f"k{i}", workload="w", arch="A", arch_key="A", granularity="line",
        objective="edp", priority="latency", latency_cc=lat, energy_pj=e,
        edp=lat * e, peak_mem_bytes=0.0, act_peak_bytes=0.0, allocation=(0,),
        ga_evaluations=0, runtime_s=0.0)
    return [mk(0, 2.0, 2.0), mk(1, 3.0, 1.0), mk(2, 2.0, 2.0),
            mk(3, 4.0, 4.0), mk(4, 0.5, 1.0)]


class StopPolicy:
    """Base class: `update(record)` returns True when the sweep should stop.

    Subclasses set `self.reason` to a human-readable explanation when they
    fire; `ExplorationSession.run` copies it onto `SweepResult.stop_reason`.

    Policies also see *failure events*: when a point exhausts its retry
    budget and is quarantined, the sweep calls `update_failure(failure)`
    with the `repro_torch.api.resilience.FailureRecord` before moving on.  The
    base implementation ignores failures; subclasses that want to stop a
    degrading sweep (e.g. `BudgetPolicy(max_failures=...)`) override it
    with the same True-means-stop contract as `update`.
    """

    reason: str | None = None

    def update(self, record: ExplorationRecord) -> bool:
        raise NotImplementedError

    def update_failure(self, failure) -> bool:
        """Observe a quarantined point; True to stop the sweep (default no)."""
        return False

    def reset(self) -> None:
        """Re-arm the policy for a new sweep (subclasses with state extend)."""
        self.reason = None


class BudgetPolicy(StopPolicy):
    """Stop when a record, scheduling, or wall-clock budget is exhausted.

    `max_records` counts every observed record (store hits included),
    `max_scheduled` only freshly computed ones — both are deterministic.
    `max_failures` counts quarantined points (via `update_failure`), so a
    sweep whose environment is falling over stops instead of burning the
    whole walk on retries; under a fixed seeded fault schedule it is as
    deterministic as the record budgets.  `max_wall_s` measures wall time
    from the first record and is therefore *not* deterministic across
    machines; use it as a safety net, not as a reproducibility boundary.

        >>> p = BudgetPolicy(max_records=3)
        >>> [p.update(r) for r in _demo_stream()[:4]]
        [False, False, True, True]
        >>> p.reason
        'budget: 3 records'
        >>> p = BudgetPolicy(max_scheduled=2)    # store hits are free
        >>> import dataclasses
        >>> hits = [dataclasses.replace(r, from_store=True)
        ...         for r in _demo_stream()]
        >>> [p.update(r) for r in hits]
        [False, False, False, False, False]
        >>> p = BudgetPolicy(max_failures=2)
        >>> [p.update_failure(f) for f in ("boom", "boom")]  # any FailureRecord
        [False, True]
        >>> p.reason
        'budget: 2 quarantined points'
    """

    def __init__(self, max_records: int | None = None,
                 max_scheduled: int | None = None,
                 max_wall_s: float | None = None,
                 max_failures: int | None = None):
        if max_records is None and max_scheduled is None \
                and max_wall_s is None and max_failures is None:
            raise ValueError("BudgetPolicy needs at least one budget")
        self.max_records = max_records
        self.max_scheduled = max_scheduled
        self.max_wall_s = max_wall_s
        self.max_failures = max_failures
        self.reset()

    def reset(self) -> None:
        super().reset()
        self.n_records = 0
        self.n_scheduled = 0
        self.n_failures = 0
        self._t0: float | None = None

    def update_failure(self, failure) -> bool:
        self.n_failures += 1
        if self.max_failures is not None \
                and self.n_failures >= self.max_failures:
            self.reason = f"budget: {self.max_failures} quarantined points"
            return True
        return False

    def update(self, record: ExplorationRecord) -> bool:
        if self._t0 is None:
            # wall-time budget is a deliberately nondeterministic safety net;
            # it never reaches a record  # staticcheck: allow(wall-clock)
            self._t0 = time.perf_counter()
        self.n_records += 1
        if not record.from_store:
            self.n_scheduled += 1
        if self.max_records is not None and self.n_records >= self.max_records:
            self.reason = f"budget: {self.max_records} records"
            return True
        if self.max_scheduled is not None \
                and self.n_scheduled >= self.max_scheduled:
            self.reason = f"budget: {self.max_scheduled} scheduled points"
            return True
        if self.max_wall_s is not None \
                and time.perf_counter() - self._t0 >= self.max_wall_s:  # staticcheck: allow(wall-clock)
            self.reason = f"budget: {self.max_wall_s:g}s wall clock"
            return True
        return False


class PlateauPolicy(StopPolicy):
    """Stop after `patience` consecutive records without improving the best
    observed metric (default: best EDP) by at least `min_improvement`
    (relative — 0.02 demands a 2% better value to reset the counter).

        >>> p = PlateauPolicy(metric="edp", patience=2)
        >>> [p.update(r) for r in _demo_stream()[:4]]   # EDPs 4, 3, 4, 16
        [False, False, False, True]
        >>> p.reason
        'plateau: best edp unimproved for 2 records'
    """

    def __init__(self, metric: str = "edp", patience: int = 8,
                 min_improvement: float = 0.0):
        if patience < 1:
            raise ValueError("patience must be >= 1")
        self.metric = metric
        self.patience = patience
        self.min_improvement = float(min_improvement)
        self.reset()

    def reset(self) -> None:
        super().reset()
        self.best: float | None = None
        self.stale = 0

    def update(self, record: ExplorationRecord) -> bool:
        value = record.metric(self.metric)
        if self.best is None or value < self.best * (1 - self.min_improvement):
            self.best = min(value, self.best) if self.best is not None \
                else value
            self.stale = 0
            return False
        self.stale += 1
        if self.stale >= self.patience:
            self.reason = (f"plateau: best {self.metric} unimproved for "
                           f"{self.patience} records")
            return True
        return False


class ParetoStagnationPolicy(StopPolicy):
    """Stop after `patience` consecutive records that fail to advance the
    running Pareto front over `metrics` (all minimized).  A record advances
    the front when no earlier record dominates it and it is not a duplicate
    of a front member — catching sweeps that still improve *some* tradeoff
    even while the single best objective value plateaus.

        >>> p = ParetoStagnationPolicy(patience=2)
        >>> [p.update(r) for r in _demo_stream()[:4]]  # dup, then dominated
        [False, False, False, True]
        >>> p.reason
        'pareto front stagnant for 2 records'
    """

    def __init__(self, metrics: Sequence[str] = ("latency_cc", "energy_pj"),
                 patience: int = 8):
        if patience < 1:
            raise ValueError("patience must be >= 1")
        self.metrics = tuple(metrics)
        self.patience = patience
        self.reset()

    def reset(self) -> None:
        super().reset()
        self.front: list[tuple[float, ...]] = []
        self.stale = 0

    def _advances(self, v: tuple[float, ...]) -> bool:
        if any(all(f[k] <= v[k] for k in range(len(v))) for f in self.front):
            return False  # dominated by (or equal to) a front member
        self.front = [f for f in self.front
                      if not all(v[k] <= f[k] for k in range(len(v)))]
        self.front.append(v)
        return True

    def update(self, record: ExplorationRecord) -> bool:
        if self._advances(tuple(record.metric(m) for m in self.metrics)):
            self.stale = 0
            return False
        self.stale += 1
        if self.stale >= self.patience:
            self.reason = f"pareto front stagnant for {self.patience} records"
            return True
        return False


class TargetMetricPolicy(StopPolicy):
    """Stop as soon as any record reaches `target` on `metric` — the
    "good enough, ship it" sweep.

        >>> p = TargetMetricPolicy("edp", target=3.0)
        >>> [p.update(r) for r in _demo_stream()[:2]]   # EDP 4 then 3
        [False, True]
        >>> p.reason, p.best_key
        ('target: edp 3 <= 3', 'k1')
    """

    def __init__(self, metric: str, target: float):
        self.metric = metric
        self.target = float(target)
        self.reset()

    def reset(self) -> None:
        super().reset()
        self.best_key: str | None = None

    def update(self, record: ExplorationRecord) -> bool:
        value = record.metric(self.metric)
        if value <= self.target:
            self.best_key = record.key
            self.reason = f"target: {self.metric} {value:g} <= {self.target:g}"
            return True
        return False


class HeartbeatMonitor(StopPolicy):
    """Non-stopping observer that writes a JSON heartbeat file as the sweep
    progresses, so an external supervisor can tell a slow shard from a dead
    one (and a crash-restart test can wait for "mid-sweep" deterministically).

    Each write is atomic (tmp file + `os.replace`), so a reader never sees
    a torn heartbeat.  The file holds `done` / `failed` counts, the
    optional `total` / `shard_index` / `n_shards` identity, a monotonic
    `seq`, and `updated_unix` — a wall-clock field, for liveness
    only, never for reproducibility.  `update`/`update_failure` always
    return False: a heartbeat observes, it never stops the sweep.

    An optional `metrics` callable (e.g. a session's `metrics_snapshot`)
    is sampled at every beat and embedded under ``metrics`` in the same
    atomic write, together with a wall-clock `points_per_s` throughput —
    the fields `tools/sweep_top.py` renders fleet-wide.

        >>> import json, os, tempfile
        >>> path = os.path.join(tempfile.mkdtemp(), "hb.json")
        >>> hb = HeartbeatMonitor(path, total=5,
        ...                       metrics=lambda: {"store_records": 7})
        >>> [hb.update(r) for r in _demo_stream()[:2]]
        [False, False]
        >>> _ = hb.update_failure("boom")
        >>> beat = json.load(open(path))
        >>> beat["done"], beat["failed"], beat["total"], beat["seq"]
        (2, 1, 5, 3)
        >>> beat["metrics"]["store_records"], "points_per_s" in beat
        (7, True)
    """

    def __init__(self, path: str, total: int | None = None,
                 shard_index: int | None = None, n_shards: int | None = None,
                 metrics=None):
        self.path = path
        self.total = total
        self.shard_index = shard_index
        self.n_shards = n_shards
        self.metrics = metrics
        self.reset()

    def reset(self) -> None:
        super().reset()
        self.done = 0
        self.failed = 0
        self.seq = 0
        self._t0 = None

    def _beat(self, status: str = "running") -> None:
        # wall-clock throughput + timestamps are liveness telemetry only —
        # they never feed content-keyed records
        now = time.time()  # staticcheck: allow(wall-clock)
        if self._t0 is None:
            self._t0 = now
        elapsed = now - self._t0
        payload = {"status": status, "done": self.done, "failed": self.failed,
                   "total": self.total, "shard_index": self.shard_index,
                   "n_shards": self.n_shards, "seq": self.seq,
                   "updated_unix": now,
                   "points_per_s": (self.done / elapsed if elapsed > 0
                                    else 0.0)}
        if self.metrics is not None:
            payload["metrics"] = dict(self.metrics())
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, self.path)

    def update(self, record: ExplorationRecord) -> bool:
        self.done += 1
        self.seq += 1
        self._beat()
        return False

    def update_failure(self, failure) -> bool:
        self.failed += 1
        self.seq += 1
        self._beat()
        return False

    def finalize(self, status: str = "done") -> None:
        """Stamp a terminal heartbeat (call after the sweep finishes)."""
        self.seq += 1
        self._beat(status)
