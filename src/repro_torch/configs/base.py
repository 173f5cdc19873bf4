"""ArchConfig: one declarative config per assigned architecture, plus the
assigned input-shape set (train_4k / prefill_32k / decode_32k / long_500k).

The JAX package's `repro/configs/base.py` with the working type as a torch
dtype (`torch.bfloat16`); every other field is the reference's, but for
`rope_scaling` and the optional keys of `mla` and `moe` below, which the
port alone reads (the published DeepSeek-V2's low-rank queries, YaRN
and group-limited routing); left out, every path computes what the
reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    mixer: str = "gqa"               # gqa | mla | rwkv6 | mamba2
    ffn: str = "glu"                 # glu | gelu | moe | rwkv_cm | none
    rope: str = "rope"               # rope | mrope | none
    rope_theta: float = 1e4
    rope_scaling: dict | None = None  # YaRN (type "yarn", factor, beta_fast,
                                      # beta_slow, mscale, mscale_all_dim,
                                      # original_max_position_embeddings)
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    norm: str = "rms"                # rms | ln
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    # family-specific sub-configs
    mla: dict | None = None          # kv_lora, qk_nope, qk_rope, v_dim
                                     # [, q_lora: low-rank queries]
    moe: dict | None = None          # n_routed, top_k, n_shared, d_ff_expert,
                                     # first_dense_layers, d_ff_dense [,
                                     # n_group, topk_group: group-limited
                                     # routing; norm_topk (True),
                                     # routed_scaling (1.0)]
    ssm: dict | None = None          # d_state, headdim, expand
    hybrid: dict | None = None       # attn_every (shared attention block)
    enc: dict | None = None          # enc_layers, enc_len (frame stub), cross=True
    # attention sub-quadratic? full attention archs skip long_500k
    subquadratic: bool = False
    # citation / provenance tag
    source: str = ""

    @property
    def n_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count (reported next to configs)."""
        from repro_torch.models.module import count_params
        from repro_torch.models.zoo import build_param_specs
        return count_params(build_param_specs(self))

    def supports_shape(self, shape: ShapeConfig) -> tuple[bool, str]:
        if shape.name == "long_500k" and not self.subquadratic:
            return False, ("full-attention architecture: 500k-context decode "
                           "skipped per assignment (sub-quadratic only)")
        return True, ""
