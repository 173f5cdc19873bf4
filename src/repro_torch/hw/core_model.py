"""Accelerator-core model (paper Fig. 2b).

A core is a spatially-unrolled PE array with a private on-core memory split
into an activation buffer and a weight buffer, plus per-access energies.
Energies follow CACTI-7-style size scaling (paper extracts all SRAM costs
with CACTI 7 [4]); AiMC cores get a much lower per-MAC energy and act as a
full-array matrix-vector engine per cycle, matching Jia et al. [21] / DIANA
[38] behaviour at the granularity Stream models.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping


def cacti_like_energy_pj_per_bit(size_bytes: int) -> float:
    """CACTI-7-ish SRAM read energy per bit vs capacity (28nm-class fit).

    ~0.01 pJ/bit @1KB -> ~0.03 @64KB -> ~0.1 @1MB. Sub-linear sqrt growth, as
    CACTI reports for single-bank SRAM.
    """
    kb = max(size_bytes, 256) / 1024.0
    return 0.010 * math.sqrt(kb)


DRAM_ENERGY_PJ_PER_BIT = 3.7  # LPDDR4-class (public number, used by ZigZag setups)


@dataclasses.dataclass(frozen=True)
class CoreModel:
    name: str
    # spatial unrolling, e.g. (("C", 32), ("K", 32)) -> 1024 PEs
    dataflow: tuple[tuple[str, int], ...]
    act_mem_bytes: int
    weight_mem_bytes: int
    mac_energy_pj: float = 0.5        # 8b digital MAC incl. local control
    sram_bw_bits_per_cc: float = 512  # on-core SRAM port bandwidth
    core_type: str = "digital"        # 'digital' | 'aimc' | 'simd'
    # AiMC arrays compute one full array activation per `aimc_cc_per_op` cycles
    aimc_cc_per_op: float = 1.0
    # calibration fudge on latency (models pipeline ramp/drain, ctrl overhead)
    latency_overhead: float = 1.0
    # explicit per-bit energies (override the CACTI-style size scaling; used
    # for HBM-backed profiles where SRAM scaling does not apply)
    act_energy_override: float | None = None
    weight_energy_override: float | None = None

    @property
    def n_pe(self) -> int:
        return math.prod(u for _, u in self.dataflow)

    @property
    def unroll(self) -> Mapping[str, int]:
        return dict(self.dataflow)

    @property
    def act_energy_pj_per_bit(self) -> float:
        if self.act_energy_override is not None:
            return self.act_energy_override
        return cacti_like_energy_pj_per_bit(self.act_mem_bytes)

    @property
    def weight_energy_pj_per_bit(self) -> float:
        if self.weight_energy_override is not None:
            return self.weight_energy_override
        return cacti_like_energy_pj_per_bit(self.weight_mem_bytes)

    def supports(self, op: str) -> bool:
        if self.core_type == "simd":
            return op in ("pool", "add", "concat")
        return op in ("conv", "dwconv", "fc", "pool", "add", "concat")
