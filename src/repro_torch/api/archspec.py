"""Declarative accelerator specifications.

`ArchSpec` is the sweep-native counterpart of `repro_torch.hw.Accelerator`: a
JSON-serializable, content-hashable description of an accelerator that
materializes to the simulation object on demand.  Because the spec is pure
data it can cross process boundaries (parallel sweep workers rebuild their
engines from it), key a persistent result store, and be generated in bulk
by `ArchSpec.grid(...)` without constructing a single `CoreModel`.

Round-trips are exact for everything in `repro_torch.hw.catalog`:

    spec = ArchSpec.from_accelerator(mc_hetero())
    assert spec.to_accelerator() == mc_hetero()
    assert ArchSpec.from_json(spec.to_json()) == spec

Chiplet topologies ride along: an `ArchSpec` may carry a
`repro_torch.hw.topology.TopologySpec` (named core clusters + inter-cluster
links/hop tables), serialized inside the same JSON document and hashed into
the same content key.  Flat specs serialize exactly as before (the
`topology` entry is omitted when absent), so pre-topology content keys and
stored sweep records remain valid.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import types
from typing import Iterable, Mapping, Sequence

from repro_torch.hw.accelerator import Accelerator
from repro_torch.hw.core_model import CoreModel, DRAM_ENERGY_PJ_PER_BIT
from repro_torch.hw.topology import (LINK_BW_BITS_PER_CC, LINK_ENERGY_PJ_PER_BIT,
                               TopologySpec, partition_topology)


@dataclasses.dataclass(frozen=True)
class CoreSpec:
    """Declarative single-core description; mirrors `CoreModel` field-for-field.

    The spec is pure data: build one from a catalog core, tweak it with
    `with_`, and let `ArchSpec` materialize it back to a `CoreModel`.

        >>> from repro_torch.hw.catalog import mc_hetero
        >>> tpu = CoreSpec.from_core(mc_hetero().cores[2])
        >>> tpu.name, tpu.act_mem_bytes
        ('tpu0', 114688)
        >>> tpu.with_(act_mem_bytes=1 << 16).to_core().act_mem_bytes
        65536
    """

    name: str
    dataflow: tuple[tuple[str, int], ...]
    act_mem_bytes: int
    weight_mem_bytes: int
    mac_energy_pj: float = 0.5
    sram_bw_bits_per_cc: float = 512
    core_type: str = "digital"
    aimc_cc_per_op: float = 1.0
    latency_overhead: float = 1.0
    act_energy_override: float | None = None
    weight_energy_override: float | None = None

    @classmethod
    def from_core(cls, core: CoreModel) -> "CoreSpec":
        """Exact spec of a simulation `CoreModel` (field-for-field copy)."""
        return cls(**{f.name: getattr(core, f.name)
                      for f in dataclasses.fields(CoreModel)})

    def to_core(self) -> CoreModel:
        """Materialize the simulation `CoreModel` this spec describes."""
        return CoreModel(**dataclasses.asdict(self))

    def with_(self, **overrides) -> "CoreSpec":
        """Copy with the given fields replaced (specs are immutable)."""
        return dataclasses.replace(self, **overrides)


def _normalize_core(data: Mapping) -> CoreSpec:
    data = dict(data)
    data["dataflow"] = tuple((str(d), int(u)) for d, u in data["dataflow"])
    return CoreSpec(**data)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """Declarative accelerator: cores + interconnect (+ topology), as pure data.

        >>> from repro_torch.hw.catalog import mc_hetero
        >>> spec = ArchSpec.from_accelerator(mc_hetero())
        >>> spec.n_cores, spec.comm_style
        (5, 'bus')
        >>> ArchSpec.from_json(spec.to_json()) == spec
        True
        >>> spec.to_accelerator() == mc_hetero()
        True
    """

    name: str
    cores: tuple[CoreSpec, ...]
    bus_bw_bits_per_cc: float = 128.0
    bus_energy_pj_per_bit: float = 0.08
    dram_bw_bits_per_cc: float = 64.0
    dram_energy_pj_per_bit: float = DRAM_ENERGY_PJ_PER_BIT
    comm_style: str = "bus"
    topology: TopologySpec | None = None

    # ---- materialization -------------------------------------------------
    @classmethod
    def from_accelerator(cls, acc: Accelerator) -> "ArchSpec":
        """Exact spec of a simulation `Accelerator` (lossless)."""
        return cls(
            name=acc.name,
            cores=tuple(CoreSpec.from_core(c) for c in acc.cores),
            bus_bw_bits_per_cc=acc.bus_bw_bits_per_cc,
            bus_energy_pj_per_bit=acc.bus_energy_pj_per_bit,
            dram_bw_bits_per_cc=acc.dram_bw_bits_per_cc,
            dram_energy_pj_per_bit=acc.dram_energy_pj_per_bit,
            comm_style=acc.comm_style,
            topology=acc.topology,
        )

    def to_accelerator(self) -> Accelerator:
        """Materialize the simulation `Accelerator` (validates topology)."""
        return Accelerator(
            name=self.name,
            cores=tuple(c.to_core() for c in self.cores),
            bus_bw_bits_per_cc=self.bus_bw_bits_per_cc,
            bus_energy_pj_per_bit=self.bus_energy_pj_per_bit,
            dram_bw_bits_per_cc=self.dram_bw_bits_per_cc,
            dram_energy_pj_per_bit=self.dram_energy_pj_per_bit,
            comm_style=self.comm_style,
            topology=self.topology,
        )

    # ---- serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-ready dict.  Flat specs omit the `topology` entry entirely,
        so their serialization (and content key) is unchanged from before
        the topology model existed."""
        d = dataclasses.asdict(self)
        if d.get("topology") is None:
            d.pop("topology", None)
        return d

    @classmethod
    def from_dict(cls, data: Mapping) -> "ArchSpec":
        data = dict(data)
        data["cores"] = tuple(_normalize_core(c) for c in data["cores"])
        topo = data.get("topology")
        data["topology"] = None if topo is None \
            else TopologySpec.from_dict(topo)
        return cls(**data)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ArchSpec":
        return cls.from_dict(json.loads(text))

    def content_key(self) -> str:
        """Stable hex digest of the spec content, name included: the name
        participates in `Accelerator` equality (and thus in engine cache
        keys), so renamed aliases are deliberately distinct content and do
        not share store entries."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]

    # ---- convenience -----------------------------------------------------
    @property
    def n_cores(self) -> int:
        return len(self.cores)

    @property
    def n_clusters(self) -> int:
        """Number of chiplets/clusters (1 for flat single-die specs)."""
        return 1 if self.topology is None else self.topology.n_clusters

    def compute_cores(self) -> tuple[CoreSpec, ...]:
        return tuple(c for c in self.cores if c.core_type != "simd")

    def total_act_mem_bytes(self) -> int:
        return sum(c.act_mem_bytes for c in self.cores)

    def with_(self, **overrides) -> "ArchSpec":
        """Copy with the given fields replaced (specs are immutable)."""
        return dataclasses.replace(self, **overrides)

    def with_chiplets(self, n_chiplets: int, *, generator: str = "ring",
                      link_bw_bits_per_cc: float = LINK_BW_BITS_PER_CC,
                      link_energy_pj_per_bit: float = LINK_ENERGY_PJ_PER_BIT,
                      ) -> "ArchSpec":
        """This spec partitioned into `n_chiplets` equal clusters of its
        compute cores (SIMD helpers join cluster 0), named
        ``<name>-chip<n>``.

            >>> from repro_torch.hw.catalog import mc_hom_tpu
            >>> spec = ArchSpec.from_accelerator(mc_hom_tpu())
            >>> chip2 = spec.with_chiplets(2)
            >>> chip2.name, chip2.n_clusters
            ('MC:HomTPU-chip2', 2)
        """
        topo = partition_topology(
            self, n_chiplets, generator=generator,
            link_bw_bits_per_cc=link_bw_bits_per_cc,
            link_energy_pj_per_bit=link_energy_pj_per_bit)
        return self.with_(name=f"{self.name}-chip{n_chiplets}", topology=topo)

    # ---- grid construction ----------------------------------------------
    @classmethod
    def grid(
        cls,
        template: "CoreSpec | CoreModel",
        *,
        cores: Sequence[int] = (4,),
        act_mem_bytes: Sequence[int] | None = None,
        weight_mem_bytes: Sequence[int] | None = None,
        bus_bw_bits_per_cc: Sequence[float] = (128.0,),
        dram_bw_bits_per_cc: Sequence[float] = (64.0,),
        comm_style: Sequence[str] = ("bus",),
        chiplets: Sequence["int | TopologySpec | None"] = (None,),
        chiplet_generator: str = "ring",
        link_bw_bits_per_cc: float = LINK_BW_BITS_PER_CC,
        link_energy_pj_per_bit: float = LINK_ENERGY_PJ_PER_BIT,
        simd: "CoreSpec | CoreModel | None" = None,
        name_fmt: str | None = None,
    ) -> list["ArchSpec"]:
        """Cross-product of homogeneous multi-core variants of `template`.

        Each grid point replicates the template core `n` times (names suffixed
        `0..n-1`), optionally overriding the per-core activation/weight memory,
        and appends the shared `simd` helper core if given.  The axes are the
        architecture knobs of the paper's iso-area study (core count, SRAM
        split, bus/DRAM bandwidth, interconnect style) plus the chiplet
        partition: a `chiplets` entry of `None` keeps the flat single-die
        spec, an integer `k` partitions the compute cores into `k` equal
        clusters joined by a generated `chiplet_generator` fabric (points
        whose core count `k` does not divide are skipped), and an explicit
        `TopologySpec` is attached to the grid points whose core names its
        clusters cover exactly (other core counts are skipped), labelled by
        its axis position so distinct topologies with equal cluster counts
        cannot collide.  Unless `name_fmt` overrides it,
        every swept axis appears in the generated names, so no two grid
        points collide (a collision would make them collapse into one
        `DesignSpace` entry).

            >>> from repro_torch.hw.catalog import mc_hetero, simd_core
            >>> tpu = CoreSpec.from_core(mc_hetero().cores[2])
            >>> grid = ArchSpec.grid(tpu, cores=[2, 4], chiplets=[None, 2],
            ...                      simd=simd_core())
            >>> len(grid)                      # 2 core counts x {flat, chip2}
            4
            >>> sorted({g.n_clusters for g in grid})
            [1, 2]
        """
        if isinstance(template, CoreModel):
            template = CoreSpec.from_core(template)
        if isinstance(simd, CoreModel):
            simd = CoreSpec.from_core(simd)
        act_axis = tuple(act_mem_bytes) if act_mem_bytes is not None \
            else (template.act_mem_bytes,)
        w_axis = tuple(weight_mem_bytes) if weight_mem_bytes is not None \
            else (template.weight_mem_bytes,)
        chip_axis = tuple(chiplets)
        if name_fmt is None:
            # :g keeps sub-KiB memory sizes distinct (0.5 vs 0.75), so no
            # two grid points can share a name
            name_fmt = "{template}x{n}-a{act_kb:g}w{w_kb:g}" \
                + ("-bus{bus:g}" if len(tuple(bus_bw_bits_per_cc)) > 1 else "") \
                + ("-dram{dram:g}" if len(tuple(dram_bw_bits_per_cc)) > 1 else "") \
                + ("-{comm}" if len(tuple(comm_style)) > 1 else "") \
                + ("-chip{chip}" if len(chip_axis) > 1 else "")
        out = []
        for n, act, wmem, bus, dram, comm, (chip_i, chip) in itertools.product(
                cores, act_axis, w_axis, bus_bw_bits_per_cc,
                dram_bw_bits_per_cc, comm_style, tuple(enumerate(chip_axis))):
            core = template.with_(act_mem_bytes=act, weight_mem_bytes=wmem)
            members = tuple(core.with_(name=f"{template.name}{i}")
                            for i in range(n))
            if simd is not None:
                members += (simd,)
            if chip is None:
                topo, chip_label = None, "flat"
            elif isinstance(chip, TopologySpec):
                covered = {c for cl in chip.clusters for c in cl.cores}
                if covered != {m.name for m in members}:
                    continue  # topology describes a different core shape
                # axis position in the label: two distinct topologies with
                # equal cluster counts must not share a grid-point name
                topo, chip_label = chip, f"t{chip_i}x{chip.n_clusters}"
            else:
                if n % chip:
                    continue  # k chiplets need k | n compute cores
                # duck-typed core list: compute cores split into k clusters,
                # the SIMD helper (if any) joins cluster 0
                carrier = types.SimpleNamespace(cores=members)
                topo = partition_topology(
                    carrier, chip, generator=chiplet_generator,
                    link_bw_bits_per_cc=link_bw_bits_per_cc,
                    link_energy_pj_per_bit=link_energy_pj_per_bit)
                chip_label = str(chip)
            name = name_fmt.format(template=template.name, n=n,
                                   act_kb=act / 1024, w_kb=wmem / 1024,
                                   bus=bus, dram=dram, comm=comm,
                                   chip=chip_label)
            out.append(cls(name=name, cores=members, bus_bw_bits_per_cc=bus,
                           dram_bw_bits_per_cc=dram, comm_style=comm,
                           topology=topo))
        return out


def as_arch_spec(arch: "ArchSpec | Accelerator") -> ArchSpec:
    """Accept either representation at API boundaries.

        >>> from repro_torch.hw.catalog import sc_tpu
        >>> as_arch_spec(sc_tpu()).name
        'SC:TPU'
    """
    if isinstance(arch, ArchSpec):
        return arch
    return ArchSpec.from_accelerator(arch)


def catalog_specs(which: Iterable[str] | None = None) -> dict[str, ArchSpec]:
    """The `repro_torch.hw.catalog` architectures (exploration + validation +
    chiplet variants) as specs.

        >>> sorted(catalog_specs(["MC:Hetero", "MC:HomTPU-chip2"]))
        ['MC:Hetero', 'MC:HomTPU-chip2']
    """
    from repro_torch.hw.catalog import (CHIPLET_ARCHITECTURES,
                                  EXPLORATION_ARCHITECTURES,
                                  VALIDATION_ARCHITECTURES)
    registry = {**EXPLORATION_ARCHITECTURES, **VALIDATION_ARCHITECTURES,
                **CHIPLET_ARCHITECTURES}
    names = list(which) if which is not None else list(registry)
    return {n: ArchSpec.from_accelerator(registry[n]()) for n in names}
