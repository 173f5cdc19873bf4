"""Roofline terms of a dry run (`launch.dryrun`), with NVIDIA H100
constants: the JAX package's `repro/analysis/roofline.py` with the TPU v5e
figures replaced.

    compute term    = FLOPs / 989e12 bf16 FLOP/s a GPU
    memory term     = HBM bytes / 3.35e12 B/s a GPU
    collective term = collective bytes / 50e9 B/s a GPU

The three rates are NVIDIA's H100 SXM datasheet figures, cited and not
measured: 989 TFLOP/s dense bf16 (no sparsity), 3.35 TB/s of HBM3.  The
network term takes one 400 Gb/s NIC a GPU, 50 GB/s.  NVLink gives 900
GB/s a GPU, but only inside one node of 8 GPUs: a ring of 16 ranks (the
"data" or "model" axis of the (16, 16) mesh) spans nodes, so its slowest
links, the ones that bound it, are the NICs.  The only collective rate
ever measured on the card is gloo's host staging, about 0.6 GB/s, which
is no figure for this term.  A card set below its 700 W limit runs
slower than these rates.

FLOPs and bytes are the recorder's (`analysis.hlo`), per device: the dry
run is rank 0's program.  `xla_flops` is the framework's own count
(`torch.utils.flop_counter.FlopCounterMode`) over the same run;
`xla_bytes` is 0.0, as the framework counts no bytes.  The useful-compute
ratio compares the analytic MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D
(MoE) against the recorder's FLOPs over every device.

    >>> r = Roofline(chips=1, flops=989e12, hbm_bytes=3.35e12,
    ...              attn_tile_bytes=0.0, collective_bytes=0.0,
    ...              collective_breakdown={}, model_flops=989e12,
    ...              xla_flops=0.0, xla_bytes=0.0)
    >>> r.t_compute, r.t_memory, r.bottleneck
    (1.0, 1.0, 'compute')
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.hlo import HLOAnalysis

PEAK_FLOPS = 989e12          # dense bf16 a GPU (H100 SXM datasheet)
HBM_BW = 3.35e12             # bytes/s a GPU (H100 SXM datasheet, HBM3)
ICI_BW = 50e9                # bytes/s a GPU: one 400 Gb/s NIC (module
                             # docstring: why not NVLink's 900e9)


@dataclasses.dataclass
class Roofline:
    chips: int
    flops: float                     # recorder, PER-DEVICE
    hbm_bytes: float                 # per-device
    attn_tile_bytes: float           # on chip under a fused kernel
    collective_bytes: float          # per-device
    collective_breakdown: dict[str, float]
    model_flops: float               # analytic 6*N*D-style, GLOBAL
    xla_flops: float                 # FlopCounterMode over the same run
    xla_bytes: float

    # The dry run is rank 0's program, so each term is per-device time
    # directly (device FLOPs / device peak, etc.).
    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        """HBM term with attention score tiles fused away (a fused
        attention kernel keeps them on chip; the plain layers write
        them)."""
        return (self.hbm_bytes - self.attn_tile_bytes) / HBM_BW

    @property
    def t_memory_unfused(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: bottleneck term (perfect overlap assumption)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        t = self.step_time_s
        return self.model_flops / (t * self.chips * PEAK_FLOPS) if t else 0.0

    def summary(self) -> dict:
        return dict(
            chips=self.chips, flops=self.flops, hbm_bytes=self.hbm_bytes,
            attn_tile_bytes=self.attn_tile_bytes,
            t_memory_unfused_s=self.t_memory_unfused,
            collective_bytes=self.collective_bytes,
            collective_breakdown=self.collective_breakdown,
            t_compute_s=self.t_compute, t_memory_s=self.t_memory,
            t_collective_s=self.t_collective, bottleneck=self.bottleneck,
            model_flops=self.model_flops,
            useful_flops_ratio=self.useful_flops_ratio, mfu=self.mfu,
            xla_flops=self.xla_flops, xla_bytes=self.xla_bytes,
        )


def analyze_run(walk: HLOAnalysis, model_flops: float, chips: int,
                xla_flops: float = 0.0) -> Roofline:
    """The reference's `analyze_compiled` over a recorded run: `walk` the
    recorder's counts, `xla_flops` FlopCounterMode's over the same run."""
    return Roofline(
        chips=chips, flops=walk.flops, hbm_bytes=walk.hbm_bytes,
        attn_tile_bytes=walk.attn_tile_bytes,
        collective_bytes=walk.total_collective_bytes,
        collective_breakdown=walk.collective_bytes,
        model_flops=model_flops, xla_flops=float(xla_flops), xla_bytes=0.0,
    )
