"""Multi-core accelerator model (paper Fig. 2a).

Cores are interconnected by a shared communication bus (limited bandwidth,
FCFS contention) or a shared on-chip memory (DIANA-style); every core reaches
off-chip DRAM through one shared limited-bandwidth DRAM port.

An optional `topology` refines the single shared bus into named core
clusters (chiplets) with per-link bandwidth/energy and multi-hop routes
between them — see `repro_torch.hw.topology`.  `topology=None` (the default, and
every catalog architecture) keeps the flat one-bus model.
"""
from __future__ import annotations

import dataclasses

from repro_torch.hw.core_model import CoreModel, DRAM_ENERGY_PJ_PER_BIT
from repro_torch.hw.topology import TopologySpec


@dataclasses.dataclass(frozen=True)
class Accelerator:
    name: str
    cores: tuple[CoreModel, ...]
    bus_bw_bits_per_cc: float = 128.0     # paper Sec. V: 128 bit/cc bus
    bus_energy_pj_per_bit: float = 0.08
    dram_bw_bits_per_cc: float = 64.0     # paper Sec. V: 64 bit/cc DRAM port
    dram_energy_pj_per_bit: float = DRAM_ENERGY_PJ_PER_BIT
    comm_style: str = "bus"               # 'bus' | 'shared_mem'
    topology: TopologySpec | None = None  # None = flat single shared bus

    def __post_init__(self):
        if self.topology is not None:
            if self.comm_style == "shared_mem":
                raise ValueError(
                    "comm_style='shared_mem' pools all activations in one "
                    "L1 and inserts no transfer nodes, so a cluster "
                    "topology would silently not be priced; use "
                    "comm_style='bus' with a topology")
            self.topology.validate([c.name for c in self.cores])

    @property
    def n_cores(self) -> int:
        return len(self.cores)

    @property
    def simd_core_id(self) -> int | None:
        for i, c in enumerate(self.cores):
            if c.core_type == "simd":
                return i
        return None

    def compute_core_ids(self) -> list[int]:
        return [i for i, c in enumerate(self.cores) if c.core_type != "simd"]

    def total_act_mem(self) -> int:
        return sum(c.act_mem_bytes for c in self.cores)
