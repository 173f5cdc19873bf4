"""Attention blocks: GQA/MQA (llama-family), with prefill (blocked
attention) and decode (KV cache) paths — the GQA part of the JAX package's
`repro/models/attention.py`, plus the MLA parameter specs.

Caches are written in place where the reference returns a donated copy
(`dynamic_update_slice`), and the same dict is returned. The MLA layer and
its latent cache are ROADMAP queue 1, item 9; M-RoPE is item 8.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (apply_rope, blocked_attention,
                                       decode_attention)
from repro_torch.models.module import ParamSpec


# ---------------------------------------------------------------------------
# GQA / MQA
# ---------------------------------------------------------------------------

def gqa_specs(d_model: int, n_heads: int, n_kv: int, head_dim: int,
              dtype=torch.bfloat16):
    return {
        "wq": ParamSpec((d_model, n_heads * head_dim), dtype, ("embed", "heads")),
        "wk": ParamSpec((d_model, n_kv * head_dim), dtype, ("embed", "kv_heads")),
        "wv": ParamSpec((d_model, n_kv * head_dim), dtype, ("embed", "kv_heads")),
        "wo": ParamSpec((n_heads * head_dim, d_model), dtype, ("heads", "embed")),
    }


def gqa_attention(params, x, positions, *, n_heads, n_kv, head_dim,
                  rope="rope", rope_theta=1e4, causal=True, cache=None,
                  cur_len=None, block_q=512, block_kv=1024,
                  kernels: bool = False):
    """x: (B,S,D). cache: dict(k,v: (B,T,Hkv,Dh)) for decode and prefill,
    written in place; cur_len: Python int (decode).

    Returns (out, cache)."""
    if rope not in ("rope", "none"):
        raise NotImplementedError(
            f"rope={rope!r} is not ported yet: ROADMAP queue 1, item 8")
    B, S, D = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(B, S, n_kv, head_dim)
    v = (x @ params["wv"]).reshape(B, S, n_kv, head_dim)
    if rope == "rope":
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    if cache is None:
        out = blocked_attention(q, k, v, causal=causal, block_q=block_q,
                                block_kv=block_kv, kernels=kernels)
    elif S == 1:  # decode step
        cache["k"][:, cur_len:cur_len + 1] = k
        cache["v"][:, cur_len:cur_len + 1] = v
        out = decode_attention(q, cache["k"], cache["v"], cur_len + 1,
                               kernels=kernels)
    else:  # prefill: compute attention and fill the cache
        out = blocked_attention(q, k, v, causal=causal, block_q=block_q,
                                block_kv=block_kv, kernels=kernels)
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v

    return out.reshape(B, S, -1) @ params["wo"], cache


def gqa_cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", "kv_seq", "kv_heads", None)
    return {"k": ParamSpec(shape, dtype, axes, init="zeros"),
            "v": ParamSpec(shape, dtype, axes, init="zeros")}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention) parameter specs
# ---------------------------------------------------------------------------

def mla_specs(d_model: int, n_heads: int, qk_nope: int, qk_rope: int,
              v_dim: int, kv_lora: int, dtype=torch.bfloat16):
    return {
        "wq": ParamSpec((d_model, n_heads * (qk_nope + qk_rope)), dtype,
                        ("embed", "heads")),
        "wkv_a": ParamSpec((d_model, kv_lora + qk_rope), dtype, ("embed", None)),
        "kv_norm": ParamSpec((kv_lora,), dtype, (None,), init="ones"),
        "wk_b": ParamSpec((kv_lora, n_heads * qk_nope), dtype, (None, "heads")),
        "wv_b": ParamSpec((kv_lora, n_heads * v_dim), dtype, (None, "heads")),
        "wo": ParamSpec((n_heads * v_dim, d_model), dtype, ("heads", "embed")),
    }
