"""Chiplet/NoC topology model: core clusters, inter-cluster links, hop tables.

The flat `Accelerator` models one shared communication bus between all
cores.  A `TopologySpec` refines that into *clusters* (chiplets, or NoC
tiles) of cores: each cluster keeps a local bus with the accelerator's bus
bandwidth/energy, while transfers between clusters traverse explicit
*links* (die-to-die interconnect) — one bus occupancy per hop, each hop
priced at the link's bandwidth and per-bit energy, with per-link FCFS
contention in the scheduler's event loop.

Two ways to describe the inter-cluster fabric:

* **links** — an explicit (or generated: `ring`/`mesh`) set of `LinkSpec`
  edges between clusters.  Routes are deterministic BFS shortest paths and
  a transfer occupies every link on its route in order (store-and-forward),
  so two transfers crossing the same physical link serialize on it.
* **hops** — an explicit symmetric hop-count table.  Each cluster pair gets
  one virtual channel priced at the topology's default link bandwidth and
  energy; a transfer occupies the pair's channel ``hops`` times in
  sequence, which makes its cost exactly ``hops x per-link latency/energy``.

The single-cluster topology is the exact degenerate case of the flat
model: every transfer stays on the one local bus, whose bandwidth, energy
and FCFS arithmetic are bit-identical to the flat shared bus (golden-tested
in ``tests/test_topology.py``).

    >>> t = TopologySpec.ring({"chip0": ("tpu0", "tpu1"),
    ...                        "chip1": ("tpu2", "tpu3")})
    >>> t.hop_table()
    ((0, 1), (1, 0))
    >>> TopologySpec.from_dict(t.to_dict()) == t
    True
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Mapping, Sequence

# UCIe-class die-to-die link defaults: narrower and an order of magnitude
# more energy per bit than the 128 bit/cc @ 0.08 pJ/bit on-die bus.
LINK_BW_BITS_PER_CC = 64.0
LINK_ENERGY_PJ_PER_BIT = 0.4


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Named group of cores (a chiplet) sharing one local interconnect.

    ``cores`` are *core names* and must match the owning accelerator's
    `CoreModel.name`s exactly — validated when the `Accelerator` is built.

        >>> ClusterSpec("chip0", ("tpu0", "tpu1")).cores
        ('tpu0', 'tpu1')
    """

    name: str
    cores: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Bidirectional inter-cluster link (one hop of the fabric).

    Endpoints ``a``/``b`` are cluster names.  A transfer crossing the link
    occupies it for ``bytes * 8 / bw_bits_per_cc`` cycles and pays
    ``bytes * 8 * energy_pj_per_bit`` pJ, FCFS with every other transfer
    routed over the same link.

        >>> LinkSpec("chip0", "chip1").bw_bits_per_cc
        64.0
    """

    a: str
    b: str
    bw_bits_per_cc: float = LINK_BW_BITS_PER_CC
    energy_pj_per_bit: float = LINK_ENERGY_PJ_PER_BIT


def _normalize_clusters(clusters) -> tuple[ClusterSpec, ...]:
    """Accept {name: core-names}, [ClusterSpec], or [(name, cores)]."""
    if isinstance(clusters, Mapping):
        items = [(str(n), c) for n, c in clusters.items()]
    else:
        items = []
        for entry in clusters:
            if isinstance(entry, ClusterSpec):
                items.append((entry.name, entry.cores))
            elif isinstance(entry, Mapping):   # serialized ClusterSpec
                items.append((str(entry["name"]), entry["cores"]))
            else:
                name, cores = entry
                items.append((str(name), cores))
    return tuple(ClusterSpec(name=n, cores=tuple(str(c) for c in cores))
                 for n, cores in items)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Cluster partition + inter-cluster fabric of an accelerator.

    Exactly one of ``links`` (explicit or generated edges; BFS-routed) and
    ``hops`` (explicit hop-count table; virtual per-pair channels) prices
    the inter-cluster traffic; ``link_bw_bits_per_cc`` /
    ``link_energy_pj_per_bit`` are the per-hop defaults used by the
    generators and by hop-table channels.

        >>> t = TopologySpec.ring({"a": ("c0",), "b": ("c1",), "c": ("c2",)})
        >>> [l.a + "-" + l.b for l in t.links]
        ['a-b', 'b-c', 'c-a']
        >>> t.hop_table()[0]
        (0, 1, 1)
    """

    clusters: tuple[ClusterSpec, ...]
    links: tuple[LinkSpec, ...] = ()
    hops: tuple[tuple[int, ...], ...] | None = None
    link_bw_bits_per_cc: float = LINK_BW_BITS_PER_CC
    link_energy_pj_per_bit: float = LINK_ENERGY_PJ_PER_BIT

    def __post_init__(self):
        # normalize loose inputs ({name: cores} mappings, lists, serialized
        # dicts) into the canonical hashable tuples-of-dataclasses form
        object.__setattr__(self, "clusters", _normalize_clusters(self.clusters))
        object.__setattr__(self, "links", tuple(self.links))
        if self.hops is not None:
            object.__setattr__(self, "hops", tuple(
                tuple(int(h) for h in row) for row in self.hops))

    # ---- shape ------------------------------------------------------------
    @property
    def n_clusters(self) -> int:
        return len(self.clusters)

    @property
    def cluster_names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.clusters)

    def core_to_cluster(self) -> dict[str, int]:
        """core name -> cluster index."""
        return {core: ci for ci, cl in enumerate(self.clusters)
                for core in cl.cores}

    # ---- validation --------------------------------------------------------
    def validate(self, core_names: Sequence[str] | None = None) -> "TopologySpec":
        """Raise ``ValueError`` on structural problems; return ``self``.

        With ``core_names`` (the owning accelerator's core names) the
        cluster partition must cover exactly those cores, each once.
        """
        if not self.clusters:
            raise ValueError("topology needs at least one cluster")
        names = [c.name for c in self.clusters]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate cluster names in {names}")
        members = [core for c in self.clusters for core in c.cores]
        if len(set(members)) != len(members):
            raise ValueError("a core appears in more than one cluster")
        if core_names is not None and (set(members) != set(core_names)
                                       or len(members) != len(core_names)):
            raise ValueError(
                f"clusters cover cores {sorted(members)} but the accelerator "
                f"has cores {sorted(core_names)}")
        if self.links and self.hops is not None:
            raise ValueError("pass either links or an explicit hop table, "
                             "not both")
        idx = {n: i for i, n in enumerate(names)}
        for l in self.links:
            if l.a not in idx or l.b not in idx:
                raise ValueError(f"link {l.a}-{l.b} references unknown cluster")
            if l.a == l.b:
                raise ValueError(f"self-link on cluster {l.a}")
            if l.bw_bits_per_cc <= 0:
                raise ValueError(f"link {l.a}-{l.b} needs positive bandwidth")
        if self.hops is not None:
            n = self.n_clusters
            if len(self.hops) != n or any(len(r) != n for r in self.hops):
                raise ValueError(f"hop table must be {n}x{n}")
            for i in range(n):
                if self.hops[i][i] != 0:
                    raise ValueError("hop table diagonal must be zero")
                for j in range(n):
                    if self.hops[i][j] != self.hops[j][i]:
                        raise ValueError("hop table must be symmetric")
                    if i != j and self.hops[i][j] < 1:
                        raise ValueError(
                            "distinct clusters need at least one hop")
            if self.link_bw_bits_per_cc <= 0:
                raise ValueError("hop-table pricing needs positive "
                                 "link_bw_bits_per_cc")
        elif self.n_clusters > 1:
            # links mode: the fabric must reach every cluster
            dist = self._bfs_distances()
            unreachable = [names[i] for i in range(self.n_clusters)
                           if dist[0][i] < 0]
            if unreachable:
                raise ValueError(
                    f"clusters {unreachable} unreachable from {names[0]}: "
                    "add links or pass an explicit hop table")
        return self

    # ---- routing -----------------------------------------------------------
    def _adjacency(self) -> list[list[tuple[int, int]]]:
        """Per cluster: sorted (neighbor cluster, link index) pairs."""
        idx = {n: i for i, n in enumerate(self.cluster_names)}
        adj: list[list[tuple[int, int]]] = [[] for _ in self.clusters]
        for li, l in enumerate(self.links):
            a, b = idx[l.a], idx[l.b]
            adj[a].append((b, li))
            adj[b].append((a, li))
        for entry in adj:
            entry.sort()
        return adj

    def _bfs_distances(self) -> list[list[int]]:
        """All-pairs shortest hop counts over the links (-1 = unreachable)."""
        n = self.n_clusters
        adj = self._adjacency()
        out = []
        for s in range(n):
            dist = [-1] * n
            dist[s] = 0
            q = deque([s])
            while q:
                u = q.popleft()
                for v, _ in adj[u]:
                    if dist[v] < 0:
                        dist[v] = dist[u] + 1
                        q.append(v)
            out.append(dist)
        return out

    def hop_table(self) -> tuple[tuple[int, ...], ...]:
        """Cluster-pair hop counts: the explicit table, or BFS shortest
        paths over the links (deterministic; 0 on the diagonal)."""
        if self.hops is not None:
            return self.hops
        return tuple(tuple(row) for row in self._bfs_distances())

    def link_routes(self) -> list[list[tuple[int, ...]]]:
        """``routes[i][j]``: link indices a transfer i->j traverses in order
        (BFS shortest path with deterministic lowest-index tie-breaks).
        Only meaningful in links mode; ``routes[i][i] == ()``."""
        n = self.n_clusters
        adj = self._adjacency()
        routes: list[list[tuple[int, ...]]] = [[()] * n for _ in range(n)]
        for s in range(n):
            prev: dict[int, tuple[int, int] | None] = {s: None}
            q = deque([s])
            while q:
                u = q.popleft()
                for v, li in adj[u]:
                    if v not in prev:
                        prev[v] = (u, li)
                        q.append(v)
            for t in range(n):
                if t == s or t not in prev:
                    continue
                path: list[int] = []
                v = t
                while prev[v] is not None:
                    u, li = prev[v]          # type: ignore[misc]
                    path.append(li)
                    v = u
                routes[s][t] = tuple(reversed(path))
        return routes

    # ---- generators --------------------------------------------------------
    @classmethod
    def ring(cls, clusters, *, link_bw_bits_per_cc: float = LINK_BW_BITS_PER_CC,
             link_energy_pj_per_bit: float = LINK_ENERGY_PJ_PER_BIT,
             ) -> "TopologySpec":
        """Ring fabric: each cluster linked to its neighbors (2 clusters get
        one link; 1 cluster gets none — the degenerate flat case).

            >>> TopologySpec.ring({"a": ("x",), "b": ("y",)}).hop_table()
            ((0, 1), (1, 0))
        """
        cl = _normalize_clusters(clusters)
        n = len(cl)
        pairs = [] if n < 2 else [(0, 1)] if n == 2 else \
            [(i, (i + 1) % n) for i in range(n)]
        links = tuple(LinkSpec(cl[a].name, cl[b].name, link_bw_bits_per_cc,
                               link_energy_pj_per_bit) for a, b in pairs)
        return cls(clusters=cl, links=links,
                   link_bw_bits_per_cc=link_bw_bits_per_cc,
                   link_energy_pj_per_bit=link_energy_pj_per_bit)

    @classmethod
    def mesh(cls, clusters, cols: int | None = None, *,
             link_bw_bits_per_cc: float = LINK_BW_BITS_PER_CC,
             link_energy_pj_per_bit: float = LINK_ENERGY_PJ_PER_BIT,
             ) -> "TopologySpec":
        """2D-mesh fabric: clusters laid out row-major on a ``cols``-wide
        grid (default: near-square), linked to their right and down
        neighbors.

            >>> t = TopologySpec.mesh({f"t{i}": (f"c{i}",) for i in range(4)},
            ...                       cols=2)
            >>> t.hop_table()[0]      # t0 -> (t0, t1, t2, t3)
            (0, 1, 1, 2)
        """
        cl = _normalize_clusters(clusters)
        n = len(cl)
        if cols is None:
            cols = max(1, int(math.isqrt(n)))
        pairs = []
        for i in range(n):
            if (i % cols) + 1 < cols and i + 1 < n:
                pairs.append((i, i + 1))            # right neighbor
            if i + cols < n:
                pairs.append((i, i + cols))         # down neighbor
        links = tuple(LinkSpec(cl[a].name, cl[b].name, link_bw_bits_per_cc,
                               link_energy_pj_per_bit) for a, b in pairs)
        return cls(clusters=cl, links=links,
                   link_bw_bits_per_cc=link_bw_bits_per_cc,
                   link_energy_pj_per_bit=link_energy_pj_per_bit)

    # ---- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Mapping) -> "TopologySpec":
        data = dict(data)
        data["clusters"] = _normalize_clusters(data["clusters"])
        data["links"] = tuple(
            LinkSpec(a=str(l["a"]), b=str(l["b"]),
                     bw_bits_per_cc=float(l["bw_bits_per_cc"]),
                     energy_pj_per_bit=float(l["energy_pj_per_bit"]))
            for l in data.get("links", ()))
        hops = data.get("hops")
        data["hops"] = None if hops is None else tuple(
            tuple(int(h) for h in row) for row in hops)
        return cls(**data)


def partition_topology(cores, n_chiplets: int, *, generator: str = "ring",
                       cluster_prefix: str = "chip",
                       link_bw_bits_per_cc: float = LINK_BW_BITS_PER_CC,
                       link_energy_pj_per_bit: float = LINK_ENERGY_PJ_PER_BIT,
                       ) -> TopologySpec:
    """Equal contiguous partition of compute cores into ``n_chiplets``.

    ``cores`` is an `Accelerator`/`ArchSpec` (its compute cores are split;
    SIMD helper cores join cluster 0) or a plain sequence of core names.
    The inter-cluster fabric comes from ``generator`` ('ring' | 'mesh').

        >>> t = partition_topology(["a", "b", "c", "d"], 2)
        >>> [c.cores for c in t.clusters]
        [('a', 'b'), ('c', 'd')]
    """
    members = getattr(cores, "cores", None)
    if members is not None:
        compute = [c.name for c in members
                   if getattr(c, "core_type", "digital") != "simd"]
        extra = [c.name for c in members
                 if getattr(c, "core_type", "digital") == "simd"]
    else:
        compute, extra = [str(c) for c in cores], []
    if n_chiplets < 1:
        raise ValueError(f"n_chiplets must be >= 1, got {n_chiplets}")
    if len(compute) % n_chiplets:
        raise ValueError(
            f"{len(compute)} compute cores do not split into "
            f"{n_chiplets} equal chiplets")
    per = len(compute) // n_chiplets
    clusters = []
    for k in range(n_chiplets):
        group = list(compute[k * per:(k + 1) * per])
        if k == 0:
            group += extra
        clusters.append((f"{cluster_prefix}{k}", group))
    gen = {"ring": TopologySpec.ring, "mesh": TopologySpec.mesh}.get(generator)
    if gen is None:
        raise ValueError(f"unknown topology generator {generator!r} "
                         "(expected 'ring' or 'mesh')")
    return gen(clusters, link_bw_bits_per_cc=link_bw_bits_per_cc,
               link_energy_pj_per_bit=link_energy_pj_per_bit)


def build_channels(accelerator):
    """Flatten an accelerator's topology into scheduler channel resources.

    Returns ``(chan_bw, chan_e, routes)``: per-channel bandwidths
    (bits/cc) and energies (pJ/bit), and ``routes[u_core][v_core]`` — the
    tuple of channel ids a u->v transfer occupies in order.  Channels
    ``0..n_clusters-1`` are the per-cluster local buses carrying the
    accelerator's flat bus bandwidth/energy (so a single-cluster topology
    reproduces the flat shared-bus arithmetic bit-for-bit); later ids are
    links (links mode) or virtual cluster-pair channels, occupied once per
    hop (hop-table mode).
    """
    topo = accelerator.topology
    names = [c.name for c in accelerator.cores]
    c2c = topo.core_to_cluster()
    cluster_of = [c2c[nm] for nm in names]
    n_cl = topo.n_clusters
    chan_bw = [float(accelerator.bus_bw_bits_per_cc)] * n_cl
    chan_e = [float(accelerator.bus_energy_pj_per_bit)] * n_cl
    croute: list[list[tuple[int, ...]]] = [[(i,)] * n_cl for i in range(n_cl)]
    if topo.hops is not None:
        pair: dict[tuple[int, int], int] = {}
        for i in range(n_cl):
            for j in range(i + 1, n_cl):
                pair[(i, j)] = len(chan_bw)
                chan_bw.append(float(topo.link_bw_bits_per_cc))
                chan_e.append(float(topo.link_energy_pj_per_bit))
        for i in range(n_cl):
            for j in range(n_cl):
                if i != j:
                    ch = pair[(i, j) if i < j else (j, i)]
                    croute[i][j] = (ch,) * topo.hops[i][j]
    else:
        base = len(chan_bw)
        for l in topo.links:
            chan_bw.append(float(l.bw_bits_per_cc))
            chan_e.append(float(l.energy_pj_per_bit))
        link_routes = topo.link_routes()
        for i in range(n_cl):
            for j in range(n_cl):
                if i != j:
                    croute[i][j] = tuple(base + li for li in link_routes[i][j])
    n = len(names)
    routes = [[croute[cluster_of[u]][cluster_of[v]] for v in range(n)]
              for u in range(n)]
    return chan_bw, chan_e, routes
