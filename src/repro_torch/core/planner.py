"""Stream -> TPU planner: the paper's framework as a first-class feature of
the training stack.

The key observation: a pipeline-parallel LM step IS a layer-fused scheduling
problem. Map it onto Stream's IR:

  * accelerator core  <- pipeline stage (a slice of the pod's chips),
  * layer             <- transformer block (fwd; + its bwd twin for training),
    expressed as a conv-like layer with OY = tokens: Stream's OY-splitting
    (Step 1) then IS microbatching, the R-tree depgen (Step 2) builds the
    pipeline DAG, the GA (Step 4) allocates blocks to stages, and the
    latency-/memory-prioritized scheduler (Step 5) orders microbatches —
    latency priority reproduces an eager GPipe-like schedule, memory priority
    discovers 1F1B-style early-backward consumption (paper Fig. 7 at pod
    scale),
  * inter-core bus    <- ICI links (activation transfers between stages),
  * DRAM port         <- host/offload traffic (unused in the default plan),
  * CACTI energies    <- public TPU-class per-byte/per-flop energies.

`plan(cfg, shape, ...)` searches stage counts x microbatch counts and
returns the Pareto/latency-best PipelinePlan used by train/pipeline.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.costmodel import CostModel
from repro_torch.core.depgraph import build_cn_graph
from repro_torch.core.cn import identify_cns
from repro_torch.core.ga import GeneticAllocator
from repro_torch.core.scheduler import ScheduleResult, schedule
from repro_torch.core.workload import Workload
from repro_torch.hw.accelerator import Accelerator
from repro_torch.hw.core_model import CoreModel
from repro_torch.models.zoo import active_params

# TPU v5e-class constants (per chip)
PEAK_MACS_PER_CC = 131072          # 8 MXUs x 128x128 @ bf16
CLOCK_HZ = 0.94e9                  # ->  ~197 TFLOP/s bf16 per chip
HBM_BYTES = 16 << 30
HBM_BW_BITS_PER_CC = int(819e9 * 8 / CLOCK_HZ)
ICI_BITS_PER_CC = int(50e9 * 8 / CLOCK_HZ)
FLOP_ENERGY_PJ = 0.5               # ~200 W / 197 TFLOP/s x utilization slack
HBM_ENERGY_PJ_PER_BIT = 1.4        # public HBM2e-class estimate


def tpu_stage_core(chips_per_stage: int, name: str) -> CoreModel:
    """One pipeline stage modeled as a fused Stream core.

    The chips multiply the spatial array in both C and K (2D factorization,
    so d_model-sized dims stay well utilized); SRAM bandwidth models VMEM
    (generous — the roofline memory term is tracked by the HLO walker, not
    this planner); energies use HBM-class per-bit numbers.
    """
    c_mult = 1 << (chips_per_stage.bit_length() - 1).__floordiv__(2)
    k_mult = chips_per_stage // c_mult
    return CoreModel(
        name=name,
        dataflow=(("C", 256 * c_mult), ("K", 512 * k_mult)),
        act_mem_bytes=int(HBM_BYTES * chips_per_stage * 0.35),
        weight_mem_bytes=int(HBM_BYTES * chips_per_stage * 0.55),
        mac_energy_pj=2 * FLOP_ENERGY_PJ,
        sram_bw_bits_per_cc=PEAK_MACS_PER_CC * 16 * chips_per_stage,  # VMEM
        core_type="digital",
        act_energy_override=HBM_ENERGY_PJ_PER_BIT,
        weight_energy_override=HBM_ENERGY_PJ_PER_BIT,
    )


def tpu_pod_accelerator(n_stages: int, chips_per_stage: int) -> Accelerator:
    cores = tuple(tpu_stage_core(chips_per_stage, f"stage{i}")
                  for i in range(n_stages))
    # NOTE: weights are HBM-resident on TPU (HBM plays the "on-core SRAM"
    # role in this mapping), so the Stream "off-chip DRAM port" must not
    # charge per-layer weight fetches — it is made effectively free here and
    # only matters for host-offload variants.
    return Accelerator(
        f"tpu-pod-{n_stages}x{chips_per_stage}", cores,
        bus_bw_bits_per_cc=ICI_BITS_PER_CC * chips_per_stage,  # stage boundary links
        bus_energy_pj_per_bit=0.3,
        dram_bw_bits_per_cc=HBM_BW_BITS_PER_CC * n_stages * chips_per_stage,
        dram_energy_pj_per_bit=0.01,
        comm_style="bus",
    )


def lm_block_workload(cfg: ArchConfig, shape: ShapeConfig,
                      include_backward: bool) -> Workload:
    """One conv-like layer per transformer block; OY = tokens."""
    tokens = shape.global_batch * shape.seq_len
    d = cfg.d_model
    block_params = (active_params(cfg)
                    - cfg.vocab * d * (1 if cfg.tie_embeddings else 2)) \
        // cfg.n_layers
    w = Workload(f"{cfg.name}-{shape.name}-blocks")
    prev = None
    fwd_ids = []
    for l in range(cfg.n_layers):
        lid = w.add(f"fwd{l}", "conv",
                    {"K": d, "C": max(block_params // d, 1), "OY": tokens,
                     "OX": 1, "FY": 1, "FX": 1},
                    inputs=() if prev is None else (prev,), bits=16)
        fwd_ids.append(lid)
        prev = lid
    if include_backward:
        for l in reversed(range(cfg.n_layers)):
            # bwd block: ~2x fwd compute; consumes bwd(l+1) + stashed fwd(l)
            lid = w.add(f"bwd{l}", "conv",
                        {"K": d, "C": max(2 * block_params // d, 1),
                         "OY": tokens, "OX": 1, "FY": 1, "FX": 1},
                        inputs=(prev, fwd_ids[l]), bits=16)
            prev = lid
    return w


@dataclasses.dataclass
class PipelinePlan:
    n_stages: int
    chips_per_stage: int
    n_microbatches: int
    layer_to_stage: np.ndarray          # fwd blocks -> stage id
    est_step_s: float
    est_peak_bytes: float
    est_energy_j: float
    schedule: ScheduleResult
    priority: str

    def summary(self) -> dict:
        return dict(n_stages=self.n_stages,
                    chips_per_stage=self.chips_per_stage,
                    n_microbatches=self.n_microbatches,
                    est_step_s=self.est_step_s,
                    est_peak_gb=self.est_peak_bytes / 2**30,
                    est_energy_j=self.est_energy_j,
                    priority=self.priority)


def evaluate_pipeline(cfg: ArchConfig, shape: ShapeConfig, *, n_stages: int,
                      chips_per_stage: int, n_microbatches: int,
                      priority: str = "latency", use_ga: bool = False,
                      seed: int = 0) -> PipelinePlan:
    include_bwd = shape.kind == "train"
    w = lm_block_workload(cfg, shape, include_bwd)
    acc = tpu_pod_accelerator(n_stages, chips_per_stage)
    cns = identify_cns(w, ("tile", n_microbatches, 1))
    graph = build_cn_graph(w, cns)
    cm = CostModel(w, acc)

    n_fwd = cfg.n_layers
    if use_ga and n_stages > 1:
        feas = [list(range(n_stages))] * len(w)

        def evaluate(genome):
            r = schedule(graph, cm, genome, acc, priority, segment=False)
            return (r.latency_cc, r.energy_pj)

        ga = GeneticAllocator(len(w), feas, evaluate, pop_size=16,
                              generations=10, seed=seed)
        # seed with the contiguous split (bwd mirrors fwd)
        init = contiguous_allocation(cfg.n_layers, n_stages, include_bwd)
        alloc = ga.run(initial=[init]).best_genome
    else:
        alloc = contiguous_allocation(cfg.n_layers, n_stages, include_bwd)

    res = schedule(graph, cm, alloc, acc, priority, segment=False)
    return PipelinePlan(
        n_stages=n_stages, chips_per_stage=chips_per_stage,
        n_microbatches=n_microbatches,
        layer_to_stage=np.asarray(alloc[:n_fwd]),
        est_step_s=res.latency_cc / CLOCK_HZ,
        est_peak_bytes=res.act_peak_bytes,
        est_energy_j=res.energy_pj * 1e-12,
        schedule=res, priority=priority)


def contiguous_allocation(n_layers: int, n_stages: int,
                          include_bwd: bool) -> np.ndarray:
    per = int(np.ceil(n_layers / n_stages))
    fwd = np.minimum(np.arange(n_layers) // per, n_stages - 1)
    if not include_bwd:
        return fwd
    # bwd blocks were appended in reversed layer order; each runs on its
    # fwd twin's stage (1F1B residency)
    return np.concatenate([fwd, fwd[::-1]])


def plan(cfg: ArchConfig, shape: ShapeConfig, total_chips: int = 256,
         stage_options=(1, 2, 4, 8), micro_options=(4, 8, 16, 32),
         priority: str = "latency", use_ga: bool = False) -> PipelinePlan:
    """Search (stages x microbatches); returns the latency-best plan."""
    best = None
    for ns in stage_options:
        if total_chips % ns or cfg.n_layers % ns:
            continue
        for nm in micro_options:
            if shape.global_batch % nm and shape.kind == "train":
                continue
            p = evaluate_pipeline(cfg, shape, n_stages=ns,
                                  chips_per_stage=total_chips // ns,
                                  n_microbatches=nm, priority=priority,
                                  use_ga=use_ga)
            if best is None or p.est_step_s < best.est_step_s:
                best = p
    assert best is not None
    return best
