"""Distributed sweep runtime: shard manifests, shard execution, store merging.

`DesignPoint`s are pure data and `ResultStore`s are append-only JSONL, so a
sweep distributes trivially: partition the space into self-contained JSON
*shard manifests* (point content keys + spec blobs + the workload DAGs they
reference), run each shard on any machine with `run_shard` (or
``python tools/run_shard.py manifest.json --shard 2/8``), and fold the
per-shard stores back together with `ResultStore.merge` — the merged record
set is bit-identical (content keys and every metric value) to the serial
run, because each point's result is a deterministic function of its spec.

    manifest = build_manifest(space, order="nearest-arch")
    manifest.save("sweep.json")
    # on worker k of n (any machine, no shared filesystem needed):
    run_shard("sweep.json", cache_dir=f"shard{k}", shard=(k, n))
    # back home:
    store = ResultStore.merge("shard0", "shard1", ..., cache_dir="merged")

Sharding is deterministic: the manifest fixes the walk order (including the
`order="nearest-arch"` similarity chaining), and `shard(space, n, k)` takes
the k-th of n contiguous balanced slices of that walk — contiguity keeps
each shard inside one similarity neighborhood, so store-backed GA warm
starts keep hitting within a shard.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, Mapping

from repro_torch.api.designspace import DesignPoint, DesignSpace, order_points
from repro_torch.api.policies import HeartbeatMonitor
from repro_torch.api.resilience import RetryPolicy
from repro_torch.api.session import (ExplorationSession, ResultStore, SweepResult)
from repro_torch.core.workload import Workload

MANIFEST_VERSION = 1


def _shard_bounds(n_points: int, n_shards: int, k: int) -> tuple[int, int]:
    """[start, end) of the k-th of n contiguous balanced slices.

        >>> [_shard_bounds(10, 3, k) for k in range(3)]
        [(0, 4), (4, 7), (7, 10)]
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not 0 <= k < n_shards:
        raise ValueError(f"shard index {k} outside 0..{n_shards - 1}")
    q, r = divmod(n_points, n_shards)
    start = k * q + min(k, r)
    return start, start + q + (1 if k < r else 0)


@dataclasses.dataclass
class SweepManifest:
    """Self-contained, JSON-serializable description of (part of) a sweep.

    Holds one entry per design point — its content key plus the full spec
    blob — and the workload DAGs the specs reference, so a bare process on
    another machine can rebuild every `DesignPoint` without importing any
    workload registry.  `design_points()` verifies each rebuilt point
    hashes back to its stored content key, catching manifest corruption or
    serialization drift before any scheduling work runs.

        >>> from repro_torch.api.designspace import DesignSpace, GAConfig
        >>> from repro_torch.hw.catalog import sc_tpu
        >>> space = DesignSpace(workloads=["fsrcnn"], archs={"SC:TPU": sc_tpu},
        ...                     granularities=["layer", ("tile", 8, 1)],
        ...                     ga=GAConfig(pop_size=4, generations=2))
        >>> m = build_manifest(space)
        >>> len(m), len(m.shard(2, 0)), len(m.shard(2, 1))
        (2, 1, 1)
        >>> m2 = SweepManifest.from_json(m.to_json())
        >>> [p.content_key() for p in m2.design_points()] == \\
        ...     [p.content_key() for p in space]
        True
    """

    points: list[dict]               # [{"key": ..., "spec": {...}}, ...]
    workloads: dict[str, dict]       # workload name -> Workload.to_dict()
    order: str = "declared"          # walk order the point list was built in
    n_shards: int | None = None      # set when this manifest is one shard
    shard_index: int | None = None
    version: int = MANIFEST_VERSION

    def __len__(self) -> int:
        return len(self.points)

    # ---- (de)serialization ----------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.n_shards is None:
            d.pop("n_shards"), d.pop("shard_index")
        return d

    @classmethod
    def from_dict(cls, data: Mapping) -> "SweepManifest":
        data = dict(data)
        version = int(data.get("version", MANIFEST_VERSION))
        if version > MANIFEST_VERSION:
            raise ValueError(f"manifest version {version} is newer than "
                             f"supported ({MANIFEST_VERSION})")
        return cls(points=list(data["points"]),
                   workloads=dict(data["workloads"]),
                   order=str(data.get("order", "declared")),
                   n_shards=data.get("n_shards"),
                   shard_index=data.get("shard_index"),
                   version=version)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "SweepManifest":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path: str) -> "SweepManifest":
        with open(path) as f:
            return cls.from_json(f.read())

    # ---- sharding --------------------------------------------------------
    def shard(self, n_shards: int, k: int) -> "SweepManifest":
        """The k-th of `n_shards` contiguous balanced slices (sizes differ
        by at most one point; the union over k is exactly this manifest).
        Deterministic: a pure function of the manifest's point order."""
        if self.n_shards is not None:
            raise ValueError(
                f"manifest is already shard {self.shard_index}/{self.n_shards}")
        start, end = _shard_bounds(len(self.points), n_shards, k)
        kept = self.points[start:end]
        names = {p["spec"]["workload"] for p in kept}
        return SweepManifest(
            points=kept,
            workloads={n: d for n, d in self.workloads.items() if n in names},
            order=self.order, n_shards=n_shards, shard_index=k)

    # ---- rebuilding ------------------------------------------------------
    def design_points(self) -> list[DesignPoint]:
        """Rebuild the `DesignPoint`s, verifying every content key."""
        workloads = {name: Workload.from_dict(dag)
                     for name, dag in self.workloads.items()}
        out = []
        for entry in self.points:
            spec = entry["spec"]
            name = str(spec["workload"])
            if name not in workloads:
                raise ValueError(f"manifest is missing the workload DAG "
                                 f"for {name!r}")
            point = DesignPoint.from_spec(spec, workloads[name])
            if point.content_key() != entry["key"]:
                raise ValueError(
                    f"manifest integrity: point {entry['key']} rebuilt to "
                    f"content key {point.content_key()} (corrupted manifest "
                    "or serialization drift)")
            out.append(point)
        return out


def build_manifest(space: "DesignSpace | Iterable[DesignPoint]",
                   order: str = "declared") -> SweepManifest:
    """Freeze a design space into a self-contained `SweepManifest`.

    The walk order (`"declared"` or `"nearest-arch"`) is applied here, once
    — every shard and every machine then agrees on it by construction.

        >>> from repro_torch.api.designspace import DesignSpace, GAConfig
        >>> from repro_torch.hw.catalog import EXPLORATION_ARCHITECTURES
        >>> space = DesignSpace(workloads=["fsrcnn"],
        ...                     archs=EXPLORATION_ARCHITECTURES,
        ...                     granularities=["layer"])
        >>> m = build_manifest(space, order="nearest-arch")
        >>> len(m) == len(space), sorted(m.workloads) == ["fsrcnn"]
        (True, True)
    """
    points = order_points(space, order)
    workloads: dict[str, dict] = {}
    entries = []
    for p in points:
        if p.workload_name not in workloads:
            workloads[p.workload_name] = p.workload.to_dict()
        entries.append({"key": p.content_key(), "spec": p.spec_dict()})
    return SweepManifest(points=entries, workloads=workloads, order=order)


def shard(space: "DesignSpace | Iterable[DesignPoint]", n_shards: int,
          k: int, order: str = "declared") -> SweepManifest:
    """Deterministic shard k of n of a design space, as a self-contained
    manifest (`build_manifest` + `SweepManifest.shard`).

        >>> from repro_torch.api.designspace import DesignSpace, GAConfig
        >>> from repro_torch.hw.catalog import EXPLORATION_ARCHITECTURES
        >>> space = DesignSpace(workloads=["fsrcnn"],
        ...                     archs=EXPLORATION_ARCHITECTURES,
        ...                     granularities=["layer"])
        >>> shards = [shard(space, 3, k) for k in range(3)]
        >>> [len(s) for s in shards], sum(len(s) for s in shards) == len(space)
        ([3, 2, 2], True)
    """
    return build_manifest(space, order).shard(n_shards, k)


def run_shard(
    manifest: "SweepManifest | str",
    cache_dir: str | None,
    shard: "tuple[int, int] | None" = None,
    executor: str = "serial",
    max_workers: int | None = None,
    session: ExplorationSession | None = None,
    progress=None,
    retries: int = 0,
    retry_policy: "RetryPolicy | None" = None,
    fault_injector=None,
    deadline_s: float | None = None,
    heartbeat: str | None = None,
    policies=(),
    repair: bool = False,
) -> SweepResult:
    """Execute a shard manifest, writing records to a per-shard JSONL store.

    The entrypoint a bare worker process/machine runs: load the manifest
    (path or object), optionally slice it to `shard=(k, n)` when the
    manifest covers the whole sweep, rebuild the points (content keys
    verified), and run them through a fresh `ExplorationSession` whose
    store lives at `cache_dir` — restarting a crashed shard is incremental,
    exactly like re-running a local sweep.

    Resilience knobs: `retries` gives every point that many extra attempts
    (shorthand for `retry_policy=RetryPolicy(max_attempts=retries + 1)`;
    pass `retry_policy` for backoff control), `deadline_s` re-dispatches
    stragglers under the process executor, `fault_injector` runs the shard
    under a seeded fault schedule (testing), `repair` quarantines corrupt
    store lines instead of refusing to load, and `heartbeat` names a JSON
    file that gets an atomic progress beat after every point — a
    supervisor polls it to tell a slow shard from a dead one.  Points that
    exhaust retries are quarantined into ``failures.jsonl`` next to the
    records, reported on the returned `SweepResult`, and never abort the
    shard.

        >>> from repro_torch.api.designspace import DesignSpace, GAConfig
        >>> from repro_torch.hw.catalog import sc_tpu
        >>> space = DesignSpace(workloads=["fsrcnn"], archs={"SC:TPU": sc_tpu},
        ...                     granularities=["layer", ("tile", 8, 1)],
        ...                     ga=GAConfig(pop_size=4, generations=2))
        >>> sweep = run_shard(build_manifest(space), cache_dir=None,
        ...                   shard=(0, 2), retries=1)
        >>> len(sweep), sweep.n_scheduled, sweep.n_failed
        (1, 1, 0)
    """
    if not isinstance(manifest, SweepManifest):
        manifest = SweepManifest.load(manifest)
    if shard is not None:
        k, n = shard
        manifest = manifest.shard(n, k)
    if retry_policy is None and retries:
        retry_policy = RetryPolicy(max_attempts=retries + 1)
    if session is None:
        session = ExplorationSession(cache_dir=cache_dir, repair=repair,
                                     retry_policy=retry_policy,
                                     fault_injector=fault_injector,
                                     deadline_s=deadline_s)
    points = manifest.design_points()
    policies = list(policies)
    monitor = None
    if heartbeat is not None:
        monitor = HeartbeatMonitor(heartbeat, total=len(points),
                                   shard_index=manifest.shard_index,
                                   n_shards=manifest.n_shards,
                                   metrics=session.metrics_snapshot)
        policies.append(monitor)
    try:
        sweep = session.run(points, executor=executor,
                            max_workers=max_workers,
                            progress=progress, policies=policies)
    except BaseException:
        # a dying shard still stamps a terminal beat, so the supervisor
        # (and `tools/sweep_top.py`) can tell "crashed" from "hung"
        if monitor is not None:
            monitor.finalize("crashed")
        raise
    if monitor is not None:
        # terminal status mirrors the CLI exit codes: stopped by a policy,
        # quarantined points present (exit 3), or clean completion
        if sweep.stop_reason is not None:
            monitor.finalize("stopped")
        elif sweep.n_failed:
            monitor.finalize("quarantined")
        else:
            monitor.finalize("done")
    return sweep


def merge_stores(out: str | None, *sources: "ResultStore | str",
                 require_exists: bool = True,
                 repair: bool = False) -> ResultStore:
    """Merge shard stores into one (`ResultStore.merge` + path validation).

    `sources` are store directories (holding ``records.jsonl``), ``.jsonl``
    files, or live `ResultStore`s; `out` persists the merged store (pass
    None for memory-only).  With `require_exists` (the default) a missing
    source path is an error — `require_exists=False` skips missing sources
    instead (a crashed shard should not block merging the others).
    `repair=True` quarantines corrupt mid-file store lines to ``.bad``
    sidecars instead of refusing to load.

    Failure records merge too, first-wins, and a healthy record for a key
    always supersedes any shard's failure for it — so the healthy-record
    merge of a faulted sharded sweep stays bit-identical to a fault-free
    serial run, while the quarantine history survives in the merged
    ``failures.jsonl``.

        >>> from repro_torch.api.session import _demo_records
        >>> a, b = ResultStore(), ResultStore()
        >>> for r in _demo_records():
        ...     a.put(r); b.put(r)                  # fully overlapping
        >>> len(merge_stores(None, a, b))
        3
    """
    if not require_exists:  # ResultStore.merge itself errors on missing
        sources = tuple(
            src for src in sources if isinstance(src, ResultStore)
            or os.path.exists(ResultStore.resolve_path(src))
            or os.path.exists(ResultStore.resolve_failures_path(src)))
    return ResultStore.merge(*sources, cache_dir=out, repair=repair)
