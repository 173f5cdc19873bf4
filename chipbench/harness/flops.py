"""Useful model FLOPs of a prefill wave and of a training step, and the
card's peaks: the yardstick's own copy of the program's analytic count
(6 N D for training, 2 N D for inference, N the parameters active for a
token, plus the attention products), kept here so that a change to the
program cannot move it.  Three departures from the program's count:

- the attention products are counted in every attention layer, where the
  program's count takes them once for the whole model;
- a prefill computes the output head at the last position of each prompt
  only, where the program's count takes it at every position;
- a prefill counts the real prompt tokens only, not the engine's left
  padding, so that serving fewer padded positions shows as a gain.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
989 TFLOP/s bf16 on tensor cores, 67 TFLOP/s float32 on CUDA cores,
3.35 TB/s of HBM.
"""
from __future__ import annotations

import math

from harness import spec
from harness.weights import leaves

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12


def total_params(config: dict) -> int:
    layout = spec.reference(config).param_layout(config)
    return sum(math.prod(s["shape"]) for _, s in leaves(layout))


def active_params(config: dict) -> int:
    """Parameters a token uses: all, less the routed experts it does not
    reach (E - top_k of them in each MoE layer)."""
    total = total_params(config)
    m = config.get("moe")
    if config.get("ffn") != "moe" or not m:
        return total
    n_moe = config["n_layers"] - m.get("first_dense_layers", 0)
    per_expert = 3 * config["d_model"] * m["d_ff_expert"]
    return total - n_moe * (m["n_routed"] - m["top_k"]) * per_expert


def _embed_head(config: dict) -> int:
    return config["vocab"] * config["d_model"]


def body_params(config: dict) -> int:
    """Active parameters without the embedding and the head."""
    tables = 1 if config.get("tie_embeddings") else 2
    return active_params(config) - tables * _embed_head(config)


def attention_flops(config: dict, length: int) -> float:
    """Causal attention products of one sequence, every layer: QK^T and PV
    over half the (length x length) pairs."""
    if config.get("mixer", "gqa") not in ("gqa", "mla"):
        return 0.0
    return 2.0 * length * length * config["n_heads"] * config["head_dim"] \
        * config["n_layers"]


def prefill_flops(config: dict, lengths) -> float:
    """Useful FLOPs of one prefill over prompts of the real `lengths`."""
    body, head = body_params(config), _embed_head(config)
    return sum(2.0 * body * n + attention_flops(config, n) + 2.0 * head
               for n in lengths)


def train_flops(config: dict, batch: int, seq: int) -> float:
    """Useful FLOPs of one training step (forward and backward, no
    recomputation): the head at every position."""
    n = body_params(config) + _embed_head(config)
    return 6.0 * n * batch * seq + 3.0 * batch * attention_flops(config, seq)
