"""Hardware catalog: the paper's validation targets (Fig. 9), the seven
exploration architectures (Fig. 11), and the TPU-v5e profile used by the
Stream->TPU planner.

Exploration set (paper Sec. V): every architecture has an identical area
footprint: 4096 MACs total, 1 MB of on-chip activation+weight memory spread
across the cores, a 128 bit/cc inter-core bus and a shared 64 bit/cc DRAM
port. Pool / residual-add layers run on an additional small SIMD core
(identical across architectures, as in the paper).
"""
from __future__ import annotations

import dataclasses

from repro_torch.hw.accelerator import Accelerator
from repro_torch.hw.core_model import CoreModel
from repro_torch.hw.topology import (LINK_BW_BITS_PER_CC,
                                     LINK_ENERGY_PJ_PER_BIT,
                                     partition_topology)


# ---------------------------------------------------------------------------
# shared SIMD helper core (pool / add / concat)
# ---------------------------------------------------------------------------

def simd_core(name: str = "simd") -> CoreModel:
    return CoreModel(
        name=name, dataflow=(("K", 16), ("OX", 4)), act_mem_bytes=32 * 1024,
        weight_mem_bytes=0, mac_energy_pj=0.25, sram_bw_bits_per_cc=512,
        core_type="simd",
    )


def _digital(name: str, dataflow, act_kb: int, w_kb: int, **kw) -> CoreModel:
    return CoreModel(
        name=name, dataflow=tuple(dataflow), act_mem_bytes=act_kb * 1024,
        weight_mem_bytes=w_kb * 1024, **kw,
    )


# ---------------------------------------------------------------------------
# exploration architectures (paper Fig. 11) — iso-area: 4096 MACs, 1 MB SRAM
# ---------------------------------------------------------------------------

def sc_tpu() -> Accelerator:
    return Accelerator("SC:TPU", (
        _digital("tpu0", (("C", 64), ("K", 64)), act_kb=448, w_kb=512,
                 sram_bw_bits_per_cc=4096),
        simd_core(),
    ))


def sc_eye() -> Accelerator:
    return Accelerator("SC:Eye", (
        _digital("eye0", (("OX", 256), ("FX", 4), ("FY", 4)), act_kb=448, w_kb=512,
                 sram_bw_bits_per_cc=4096),
        simd_core(),
    ))


def sc_env() -> Accelerator:
    return Accelerator("SC:Env", (
        _digital("env0", (("OX", 64), ("K", 64)), act_kb=448, w_kb=512,
                 sram_bw_bits_per_cc=4096),
        simd_core(),
    ))


def mc_hom_tpu() -> Accelerator:
    cores = tuple(_digital(f"tpu{i}", (("C", 32), ("K", 32)), act_kb=112, w_kb=128,
                           sram_bw_bits_per_cc=1024)
                  for i in range(4))
    return Accelerator("MC:HomTPU", cores + (simd_core(),))


def mc_hom_eye() -> Accelerator:
    cores = tuple(_digital(f"eye{i}", (("OX", 64), ("FX", 4), ("FY", 4)),
                           act_kb=112, w_kb=128, sram_bw_bits_per_cc=1024) for i in range(4))
    return Accelerator("MC:HomEye", cores + (simd_core(),))


def mc_hom_env() -> Accelerator:
    cores = tuple(_digital(f"env{i}", (("OX", 32), ("K", 32)), act_kb=112, w_kb=128,
                           sram_bw_bits_per_cc=1024)
                  for i in range(4))
    return Accelerator("MC:HomEnv", cores + (simd_core(),))


def mc_hetero() -> Accelerator:
    return Accelerator("MC:Hetero", (
        _digital("eye", (("OX", 64), ("FX", 4), ("FY", 4)), act_kb=112, w_kb=128,
                 sram_bw_bits_per_cc=1024),
        _digital("env", (("OX", 32), ("K", 32)), act_kb=112, w_kb=128,
                 sram_bw_bits_per_cc=1024),
        _digital("tpu0", (("C", 32), ("K", 32)), act_kb=112, w_kb=128,
                 sram_bw_bits_per_cc=1024),
        _digital("tpu1", (("C", 32), ("K", 32)), act_kb=112, w_kb=128,
                 sram_bw_bits_per_cc=1024),
        simd_core(),
    ))


EXPLORATION_ARCHITECTURES = {
    "SC:TPU": sc_tpu, "SC:Eye": sc_eye, "SC:Env": sc_env,
    "MC:HomTPU": mc_hom_tpu, "MC:HomEye": mc_hom_eye, "MC:HomEnv": mc_hom_env,
    "MC:Hetero": mc_hetero,
}


# ---------------------------------------------------------------------------
# chiplet variants: the multi-core iso-area architectures re-packaged as
# 2/4 chiplets joined by UCIe-class die-to-die links (64 bit/cc, 0.4 pJ/bit
# vs the 128 bit/cc @ 0.08 pJ/bit on-die bus).  Kept in their own registry:
# EXPLORATION_ARCHITECTURES pins the paper's Fig. 11-15 sweep.
# ---------------------------------------------------------------------------

def with_chiplets(acc: Accelerator, n_chiplets: int, *,
                  generator: str = "ring",
                  link_bw_bits_per_cc: float = LINK_BW_BITS_PER_CC,
                  link_energy_pj_per_bit: float = LINK_ENERGY_PJ_PER_BIT,
                  ) -> Accelerator:
    """`acc` partitioned into `n_chiplets` equal clusters of its compute
    cores (the SIMD helper joins cluster 0), renamed ``<name>-chip<n>``.

    ``n_chiplets=1`` is the degenerate single-cluster topology, which
    schedules bit-identically to the flat accelerator (golden-tested).
    """
    topo = partition_topology(
        acc, n_chiplets, generator=generator,
        link_bw_bits_per_cc=link_bw_bits_per_cc,
        link_energy_pj_per_bit=link_energy_pj_per_bit)
    return dataclasses.replace(acc, name=f"{acc.name}-chip{n_chiplets}",
                               topology=topo)


def mc_hom_tpu_chip2() -> Accelerator:
    return with_chiplets(mc_hom_tpu(), 2)


def mc_hom_tpu_chip4() -> Accelerator:
    return with_chiplets(mc_hom_tpu(), 4)


def mc_hetero_chip2() -> Accelerator:
    return with_chiplets(mc_hetero(), 2)


CHIPLET_ARCHITECTURES = {
    "MC:HomTPU-chip2": mc_hom_tpu_chip2,
    "MC:HomTPU-chip4": mc_hom_tpu_chip4,
    "MC:Hetero-chip2": mc_hetero_chip2,
}


# ---------------------------------------------------------------------------
# validation targets (paper Fig. 9)
# ---------------------------------------------------------------------------

def depfin() -> Accelerator:
    """DepFiN [15]: single-core depth-first pixel processor, line buffers.

    4096 MACs unrolled K4 x C4 x OX256 (pixel-parallel datapath; small K/C
    unrolls keep utilization high for the thin-channel pixel-processing
    layers DepFiN targets).
    """
    return Accelerator("DepFiN", (
        _digital("depfin", (("K", 4), ("C", 4), ("OX", 256)),
                 act_kb=192, w_kb=64, sram_bw_bits_per_cc=4096,
                 latency_overhead=1.3),  # calibrated: FSRCNN -> 5.7e6 cc (chip: 6.18e6)
        simd_core(),
    ), bus_bw_bits_per_cc=256, dram_bw_bits_per_cc=128)


def aimc_4x4() -> Accelerator:
    """Jia et al. [21]: 4x4 array of AiMC cores (1152x256 bit-cells each)."""
    cores = tuple(CoreModel(
        name=f"aimc{i}", dataflow=(("C", 128), ("FY", 3), ("FX", 3), ("K", 256)),
        act_mem_bytes=16 * 1024, weight_mem_bytes=1152 * 256,  # weights live in-array
        mac_energy_pj=0.02, core_type="aimc",
        aimc_cc_per_op=93.0,  # calibrated: input-bit serialism x ADC conversion
        sram_bw_bits_per_cc=2048,
    ) for i in range(16))
    return Accelerator("AiMC4x4", cores + (simd_core(),),
                       bus_bw_bits_per_cc=512, dram_bw_bits_per_cc=256,
                       comm_style="shared_mem")


def diana() -> Accelerator:
    """DIANA [38]: heterogeneous digital + AiMC SoC, 256 KB shared L1."""
    return Accelerator("DIANA", (
        _digital("digital", (("K", 16), ("C", 16)), act_kb=128, w_kb=64,
                 sram_bw_bits_per_cc=1024, latency_overhead=1.0),
        CoreModel(name="aimc", dataflow=(("C", 128), ("FY", 3), ("FX", 3), ("K", 512)),
                  act_mem_bytes=128 * 1024, weight_mem_bytes=1152 * 512,  # in-array
                  mac_energy_pj=0.015, core_type="aimc",
                  aimc_cc_per_op=32.0,  # calibrated vs ISSCC'22 measurement
                  sram_bw_bits_per_cc=2048),
        simd_core(),
    ), bus_bw_bits_per_cc=512, dram_bw_bits_per_cc=128, comm_style="shared_mem")


VALIDATION_ARCHITECTURES = {
    "DepFiN": depfin, "AiMC4x4": aimc_4x4, "DIANA": diana,
}

# validation setup: workload + the CN granularity the hardware supports
# (paper Sec. IV: "Each measured DNN is modelled in Stream at the scheduling
# granularity supported by the hardware"), plus the paper's Table-I numbers.
VALIDATION_SETUP = {
    "DepFiN": dict(workload="fsrcnn", granularity="line",
                   measured_cc=6.18e6, stream_cc=5.65e6,
                   measured_kb=238.0, stream_kb=244.0),
    "AiMC4x4": dict(workload="resnet50_segment", granularity="line",
                    measured_cc=3.66e5, stream_cc=3.68e5,
                    measured_kb=None, stream_kb=16.5),
    "DIANA": dict(workload="resnet18_first_segment", granularity=("tile", 28, 1),
                  measured_cc=8.12e5, stream_cc=7.83e5,
                  measured_kb=134.0, stream_kb=137.0),
}
