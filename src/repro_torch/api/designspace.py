"""Declarative design spaces: the sweep as a first-class object.

A `DesignSpace` declares the cross-product

    workloads x architectures x granularities x (objective, priority)

plus a GA budget and constraint predicates.  Constraints are evaluated on
the *specs* while enumerating points — before any CN graph is built or a
single schedule is run — so infeasible corners of a large grid cost nothing.

Each enumerated `DesignPoint` is pure data (picklable, JSON-serializable)
and carries a content key combining the workload DAG content, the
architecture spec, the granularity, and the full optimization setup; the
key is what makes sweep results reusable across runs and processes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Iterable, Iterator, Mapping, Sequence

from repro_torch.api.archspec import ArchSpec, as_arch_spec
from repro_torch.core.workload import Workload

def granularity_label(granularity) -> str:
    """Canonical short label ('layer', 'line', 'tile32x1', 'per-layer[...]').

        >>> granularity_label(("tile", 32, 1))
        'tile32x1'
        >>> granularity_label({0: "layer", 1: ("tile", 8)})
        'per-layer[0:layer,1:tile8x1]'
    """
    if isinstance(granularity, str):
        return granularity
    if isinstance(granularity, tuple) and granularity and granularity[0] == "tile":
        n_ox = granularity[2] if len(granularity) > 2 else 1
        return f"tile{granularity[1]}x{n_ox}"
    if isinstance(granularity, Mapping):
        inner = ",".join(f"{k}:{granularity_label(v)}"
                         for k, v in sorted(granularity.items()))
        return f"per-layer[{inner}]"
    return str(granularity)


def _granularity_jsonable(granularity):
    if isinstance(granularity, Mapping):
        return {str(k): _granularity_jsonable(v)
                for k, v in sorted(granularity.items())}
    if isinstance(granularity, tuple):
        return list(granularity)
    return granularity


def granularity_from_jsonable(granularity):
    """Inverse of the JSON form used in point specs and shard manifests.

    Lists become tuples and per-layer dict keys become layer ids again, so
    a rebuilt `DesignPoint` hashes to the same content key as the original.

        >>> granularity_from_jsonable(["tile", 32, 1])
        ('tile', 32, 1)
        >>> granularity_from_jsonable({"0": "layer", "1": ["tile", 8]})
        {0: 'layer', 1: ('tile', 8)}
    """
    if isinstance(granularity, list):
        return tuple(granularity)
    if isinstance(granularity, Mapping):
        return {int(k) if str(k).lstrip("-").isdigit() else k:
                granularity_from_jsonable(v)
                for k, v in granularity.items()}
    return granularity


@dataclasses.dataclass(frozen=True)
class GAConfig:
    """Budget/seed of the genetic layer-core allocator for one point.

    Part of every `DesignPoint`'s content key: changing the GA budget or
    seed is a different experiment with its own stored record.

        >>> GAConfig(pop_size=8, generations=4).seed
        0
    """

    pop_size: int = 24
    generations: int = 16
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One fully specified exploration: everything `explore()` needs.

    Pure data (picklable, JSON-serializable); `content_key()` is the
    identity of the *result* — identical keys mean identical metrics,
    which is what makes the `ResultStore` reusable across runs.

        >>> from repro_torch.configs.paper_workloads import squeezenet
        >>> from repro_torch.api.archspec import as_arch_spec
        >>> from repro_torch.hw.catalog import mc_hetero
        >>> p = DesignPoint(workload_name="squeezenet", workload=squeezenet(),
        ...                 arch=as_arch_spec(mc_hetero()),
        ...                 granularity=("tile", 32, 1))
        >>> p.granularity_label
        'tile32x1'
        >>> len(p.content_key())
        24
    """

    workload_name: str
    workload: Workload
    arch: ArchSpec
    granularity: object
    objective: str = "edp"
    priority: str = "latency"
    ga: GAConfig = GAConfig()

    @property
    def granularity_label(self) -> str:
        return granularity_label(self.granularity)

    def _spec_blob(self) -> str:
        blob = self.__dict__.get("_spec_blob_cache")
        if blob is not None:
            return blob
        blob = json.dumps({
            "workload": self.workload_name,
            "workload_content": repr(self.workload.cache_key()),
            "arch": self.arch.to_dict(),
            "granularity": _granularity_jsonable(self.granularity),
            "objective": self.objective,
            "priority": self.priority,
            "ga": dataclasses.asdict(self.ga),
        }, sort_keys=True)
        object.__setattr__(self, "_spec_blob_cache", blob)  # frozen dataclass
        return blob

    def spec_dict(self) -> dict:
        """Full specification in canonical JSON types (round-trip stable:
        tuples are already lists, so stored records compare equal)."""
        return json.loads(self._spec_blob())

    def content_key(self) -> str:
        """Identity of the *result*: identical keys => identical metrics
        (the whole pipeline is deterministic at a fixed GA seed)."""
        return hashlib.sha256(self._spec_blob().encode()).hexdigest()[:24]

    @classmethod
    def from_spec(cls, spec: Mapping, workload: Workload) -> "DesignPoint":
        """Rebuild a point from its `spec_dict()` plus the workload DAG.

        The spec carries everything except the workload itself (only its
        name and content digest), so shard manifests ship the DAG separately
        — `repro_torch.api.distributed.SweepManifest` pairs the two and verifies
        the rebuilt point hashes to the stored content key.

            >>> from repro_torch.configs.paper_workloads import fsrcnn
            >>> from repro_torch.hw.catalog import sc_tpu
            >>> p = DesignPoint(workload_name="fsrcnn", workload=fsrcnn(),
            ...                 arch=as_arch_spec(sc_tpu()),
            ...                 granularity=("tile", 8, 1))
            >>> q = DesignPoint.from_spec(p.spec_dict(), fsrcnn())
            >>> q.content_key() == p.content_key()
            True
        """
        return cls(
            workload_name=str(spec["workload"]),
            workload=workload,
            arch=ArchSpec.from_dict(spec["arch"]),
            granularity=granularity_from_jsonable(spec["granularity"]),
            objective=str(spec["objective"]),
            priority=str(spec["priority"]),
            ga=GAConfig(**spec["ga"]))


@dataclasses.dataclass(frozen=True)
class ServingSweep:
    """The serving axes of a design space: arrival rates and SLOs.

    Attaching one to a `DesignSpace` (``DesignSpace(serving=...)``) makes
    arrival rate and SLO sweepable dimensions beside arch/granularity:
    `ExplorationSession.run_serving` schedules each point's prefill/decode
    phase workloads through the ordinary sweep pipeline (store-cached,
    executor-parallel), then runs the closed-loop simulator
    (`repro_torch.serve.simulator`) once per (point, rate) and reports one
    `ServingRecord` per (point, rate, slo).

    Pure data, part of every serving record's content key.  `rates_rps`
    are request arrival rates; `slo_ms` the latency targets; requests
    decode `decode_tokens` tokens each (ignored by single-phase
    workloads); `clock_ghz` converts scheduler cycles to wall time.

        >>> sweep = ServingSweep(rates_rps=(100.0, 1000.0))
        >>> sweep.slo_ms, sweep.batch_slots
        ((50.0,), 4)
        >>> ServingSweep(rates_rps=())
        Traceback (most recent call last):
            ...
        ValueError: ServingSweep needs at least one arrival rate
    """

    rates_rps: tuple[float, ...]
    slo_ms: tuple[float, ...] = (50.0,)
    batch_slots: int = 4
    n_requests: int = 32
    seed: int = 0
    decode_tokens: int = 16
    clock_ghz: float = 1.0

    def __post_init__(self):
        # normalize list inputs to tuples (frozen: go through __setattr__)
        object.__setattr__(self, "rates_rps",
                           tuple(float(r) for r in self.rates_rps))
        object.__setattr__(self, "slo_ms",
                           tuple(float(s) for s in self.slo_ms))
        if not self.rates_rps:
            raise ValueError("ServingSweep needs at least one arrival rate")
        if any(r <= 0.0 for r in self.rates_rps):
            raise ValueError(f"arrival rates must be > 0: {self.rates_rps}")
        if not self.slo_ms:
            raise ValueError("ServingSweep needs at least one SLO")
        if self.batch_slots < 1 or self.n_requests < 1:
            raise ValueError("batch_slots and n_requests must be >= 1")
        if self.clock_ghz <= 0.0:
            raise ValueError(f"clock_ghz must be > 0, got {self.clock_ghz}")

    @property
    def clock_hz(self) -> float:
        return self.clock_ghz * 1e9


# constraint predicates receive the DesignPoint; helpers below build common ones
Constraint = Callable[[DesignPoint], bool]


def min_act_mem(n_bytes: int) -> Constraint:
    """Keep architectures with at least `n_bytes` of on-chip activation mem.

        >>> from repro_torch.hw.catalog import EXPLORATION_ARCHITECTURES
        >>> space = DesignSpace(workloads=["squeezenet"],
        ...                     archs=EXPLORATION_ARCHITECTURES,
        ...                     constraints=[min_act_mem(1 << 30)])
        >>> len(space)                  # nothing has 1 GiB of SRAM
        0
    """
    def ok(p: DesignPoint) -> bool:
        return p.arch.total_act_mem_bytes() >= n_bytes
    return ok


def max_cores(n: int) -> Constraint:
    """Keep architectures with at most `n` cores (SIMD helpers included).

        >>> from repro_torch.hw.catalog import EXPLORATION_ARCHITECTURES
        >>> space = DesignSpace(workloads=["squeezenet"],
        ...                     archs=EXPLORATION_ARCHITECTURES,
        ...                     granularities=["layer"],
        ...                     constraints=[max_cores(3)])
        >>> sorted(p.arch.name for p in space)   # 1 compute core + SIMD
        ['SC:Env', 'SC:Eye', 'SC:TPU']
    """
    def ok(p: DesignPoint) -> bool:
        return p.arch.n_cores <= n
    return ok


def max_clusters(n: int) -> Constraint:
    """Keep architectures with at most `n` chiplets/clusters (flat
    single-die specs count as 1) — the topology axis of a chiplet sweep.

        >>> from repro_torch.api.archspec import ArchSpec, as_arch_spec
        >>> from repro_torch.hw.catalog import mc_hom_tpu
        >>> spec = as_arch_spec(mc_hom_tpu()).with_chiplets(4)
        >>> spec.n_clusters
        4
    """
    def ok(p: DesignPoint) -> bool:
        return p.arch.n_clusters <= n
    return ok


def fits_weights_on_chip() -> Constraint:
    """Total weight SRAM must hold the workload's weights (no DRAM refetch).

        >>> from repro_torch.hw.catalog import EXPLORATION_ARCHITECTURES
        >>> space = DesignSpace(workloads=["squeezenet"],   # 1.2 MB weights
        ...                     archs=EXPLORATION_ARCHITECTURES,
        ...                     constraints=[fits_weights_on_chip()])
        >>> len(space)                  # iso-area archs carry 0.5 MB
        0
    """
    def ok(p: DesignPoint) -> bool:
        wmem = sum(c.weight_mem_bytes for c in p.arch.cores)
        return wmem >= p.workload.total_weight_bytes
    return ok


def _normalize_workloads(workloads) -> dict[str, Workload]:
    """Accept {name: Workload|factory}, [Workload], [(name, Workload)], or
    registry names from `repro_torch.configs.paper_workloads`."""
    items: list[tuple[str, object]] = []
    if isinstance(workloads, Mapping):
        items = list(workloads.items())
    else:
        for entry in workloads:
            if isinstance(entry, tuple):
                items.append(entry)
            elif isinstance(entry, Workload):
                items.append((entry.name, entry))
            elif isinstance(entry, str):
                from repro_torch.configs.paper_workloads import EXPLORATION_WORKLOADS
                items.append((entry, EXPLORATION_WORKLOADS[entry]))
            else:
                items.append((getattr(entry, "__name__", str(entry)), entry))
    out: dict[str, Workload] = {}
    for name, wl in items:
        wl = wl if isinstance(wl, Workload) else wl()
        prev = out.get(str(name))
        if prev is not None and prev.cache_key() != wl.cache_key():
            raise ValueError(
                f"two different workloads share the name {name!r}; "
                "pass a mapping with distinct keys to disambiguate")
        out[str(name)] = wl
    return out


def _normalize_archs(archs) -> dict[str, ArchSpec]:
    """Mapping keys are authoritative: the spec is renamed to its key, so
    two aliases of one catalog entry stay distinct points and records carry
    the declared name."""
    if isinstance(archs, Mapping):
        return {str(n): as_arch_spec(a() if callable(a) else a).with_(name=str(n))
                for n, a in archs.items()}
    out: dict[str, ArchSpec] = {}
    for a in archs:
        spec = as_arch_spec(a() if callable(a) and not isinstance(a, ArchSpec)
                            else a)
        prev = out.get(spec.name)
        if prev is not None and prev != spec:
            raise ValueError(
                f"two different architectures share the name {spec.name!r}; "
                "rename one (or pass a mapping, whose keys rename the specs)")
        out[spec.name] = spec
    return out


class DesignSpace:
    """The declared cross-product; iterating yields constraint-filtered points.

    Workloads may be registry names, `Workload`s, or factories; archs may be
    `ArchSpec`s, `Accelerator`s, factories, or a name-keyed mapping (the
    keys rename the specs).  Constraints prune on the *specs* while
    enumerating, before any CN graph is built.

        >>> from repro_torch.hw.catalog import EXPLORATION_ARCHITECTURES
        >>> space = DesignSpace(workloads=["squeezenet"],
        ...                     archs=EXPLORATION_ARCHITECTURES,
        ...                     granularities=["layer", ("tile", 32, 1)],
        ...                     constraints=[max_cores(5)])
        >>> space.size_unconstrained()
        14
        >>> len(space)                  # MC:* archs have 5 cores: all pass
        14
        >>> next(iter(space)).granularity_label
        'layer'
    """

    def __init__(
        self,
        workloads,
        archs,
        granularities: Sequence = ("line",),
        objectives: Sequence[str] = ("edp",),
        priorities: Sequence[str] = ("latency",),
        ga: GAConfig | None = None,
        constraints: Iterable[Constraint] = (),
        serving: ServingSweep | None = None,
    ):
        self.workloads = _normalize_workloads(workloads)
        self.archs = _normalize_archs(archs)
        self.granularities = list(granularities)
        self.objectives = list(objectives)
        self.priorities = list(priorities)
        self.ga = ga or GAConfig()
        self.constraints = list(constraints)
        # serving axes (arrival rate x SLO), consumed by
        # `ExplorationSession.run_serving`; None = one-shot sweeps only
        self.serving = serving

    def points(self) -> Iterator[DesignPoint]:
        for wl_name, wl in self.workloads.items():
            for arch in self.archs.values():
                for gran in self.granularities:
                    for obj in self.objectives:
                        for prio in self.priorities:
                            p = DesignPoint(
                                workload_name=wl_name, workload=wl, arch=arch,
                                granularity=gran, objective=obj, priority=prio,
                                ga=self.ga)
                            if all(c(p) for c in self.constraints):
                                yield p

    def __iter__(self) -> Iterator[DesignPoint]:
        return self.points()

    def __len__(self) -> int:
        return sum(1 for _ in self.points())

    def size_unconstrained(self) -> int:
        return (len(self.workloads) * len(self.archs) * len(self.granularities)
                * len(self.objectives) * len(self.priorities))

    def __repr__(self) -> str:  # pragma: no cover
        return (f"DesignSpace({len(self.workloads)} workloads x "
                f"{len(self.archs)} archs x {len(self.granularities)} "
                f"granularities x {len(self.objectives)} objectives x "
                f"{len(self.priorities)} priorities"
                + (f", {len(self.constraints)} constraints" if self.constraints
                   else "") + ")")


# ---------------------------------------------------------------------------
# sweep ordering: nearest-neighbor traversal of the architecture grid
# ---------------------------------------------------------------------------

POINT_ORDERS = ("declared", "nearest-arch")


def arch_spec_similarity(a: Mapping, b: Mapping) -> int:
    """Similarity score between two `ArchSpec.to_dict()` forms.

    The spec distance *is* the grid distance: +2 for an equal core count,
    +1 per slot whose core spec matches exactly, +1 per matching
    interconnect parameter (bus/DRAM bandwidth and energy, comm style).
    This single ranking backs both the store-backed GA warm starts
    (neighbor selection) and the `order="nearest-arch"` sweep traversal,
    so the walk visits exactly the neighborhoods the warm starts feed on.

        >>> from repro_torch.hw.catalog import mc_hom_tpu, mc_hom_eye, sc_tpu
        >>> hom = as_arch_spec(mc_hom_tpu()).to_dict()
        >>> eye = as_arch_spec(mc_hom_eye()).to_dict()
        >>> sc = as_arch_spec(sc_tpu()).to_dict()
        >>> arch_spec_similarity(hom, hom) > arch_spec_similarity(hom, eye)
        True
        >>> arch_spec_similarity(hom, eye) > arch_spec_similarity(hom, sc)
        True
    """
    score = 0
    cores_a, cores_b = a.get("cores", []), b.get("cores", [])
    if len(cores_a) == len(cores_b):
        score += 2
        score += sum(1 for x, y in zip(cores_a, cores_b) if x == y)
    for field in ("bus_bw_bits_per_cc", "bus_energy_pj_per_bit",
                  "dram_bw_bits_per_cc", "dram_energy_pj_per_bit",
                  "comm_style"):
        if a.get(field) == b.get(field):
            score += 1
    return score


def nearest_arch_chain(archs: Sequence[ArchSpec]) -> list[int]:
    """Greedy nearest-neighbor traversal order over unique architectures.

    Starts at the first declared arch and repeatedly hops to the most
    similar unvisited one (`arch_spec_similarity`; ties break on declared
    order), returning index positions into `archs`. Deterministic: a pure
    function of the spec contents and their declared order.

        >>> from repro_torch.hw.catalog import mc_hetero, mc_hom_tpu, sc_tpu
        >>> specs = [as_arch_spec(a()) for a in (sc_tpu, mc_hetero,
        ...                                      mc_hom_tpu)]
        >>> nearest_arch_chain(specs)   # 5-core MC:* pair stays adjacent
        [0, 1, 2]
    """
    dicts = [a.to_dict() for a in archs]
    n = len(dicts)
    if n == 0:
        return []
    chain, visited = [0], [True] + [False] * (n - 1)
    while len(chain) < n:
        cur = dicts[chain[-1]]
        best, best_score = -1, -1
        for j in range(n):
            if not visited[j]:
                s = arch_spec_similarity(cur, dicts[j])
                if s > best_score:
                    best, best_score = j, s
        visited[best] = True
        chain.append(best)
    return chain


def order_points(points: Iterable[DesignPoint],
                 order: str = "declared") -> list[DesignPoint]:
    """Walk order of a sweep: `"declared"` (as enumerated) or
    `"nearest-arch"` (architecture-major, architectures chained by spec
    similarity so consecutive points stay in neighboring grid regions —
    the traversal that makes store-backed GA warm starts hit).

        >>> from repro_torch.hw.catalog import EXPLORATION_ARCHITECTURES
        >>> space = DesignSpace(workloads=["fsrcnn"],
        ...                     archs=EXPLORATION_ARCHITECTURES,
        ...                     granularities=["layer"])
        >>> walk = order_points(space, "nearest-arch")
        >>> sorted(p.arch.name for p in walk) == \\
        ...     sorted(p.arch.name for p in space)
        True
        >>> [p.arch.name for p in walk][:2]     # SC:TPU's nearest: SC:Eye
        ['SC:TPU', 'SC:Eye']
    """
    points = list(points)
    if order == "declared":
        return points
    if order != "nearest-arch":
        raise ValueError(f"unknown order {order!r} "
                         f"(expected one of {POINT_ORDERS})")
    unique: dict[str, ArchSpec] = {}
    for p in points:
        unique.setdefault(p.arch.content_key(), p.arch)
    keys, specs = list(unique), list(unique.values())
    chain = nearest_arch_chain(specs)
    rank = {keys[idx]: pos for pos, idx in enumerate(chain)}
    return sorted(points, key=lambda p: rank[p.arch.content_key()])
