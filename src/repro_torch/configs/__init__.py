"""Config registry: the 10 assigned architectures (+ shapes) and reduced
smoke-test variants of each family, as in the JAX package's
`repro/configs/__init__.py`.  The paper workloads of the exploration path
live in `repro_torch.configs.paper_workloads`.  Importing this package
does not touch CUDA."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs.whisper_large_v3 import CONFIG as whisper_large_v3
from repro_torch.configs.command_r_35b import CONFIG as command_r_35b
from repro_torch.configs.llama32_3b import CONFIG as llama32_3b
from repro_torch.configs.deepseek_67b import CONFIG as deepseek_67b
from repro_torch.configs.granite_34b import CONFIG as granite_34b
from repro_torch.configs.rwkv6_3b import CONFIG as rwkv6_3b
from repro_torch.configs.zamba2_27b import CONFIG as zamba2_27b
from repro_torch.configs.qwen2_vl_72b import CONFIG as qwen2_vl_72b
from repro_torch.configs.deepseek_moe_16b import CONFIG as deepseek_moe_16b
from repro_torch.configs.deepseek_v2_236b import CONFIG as deepseek_v2_236b

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (
        whisper_large_v3, command_r_35b, llama32_3b, deepseek_67b,
        granite_34b, rwkv6_3b, zamba2_27b, qwen2_vl_72b, deepseek_moe_16b,
        deepseek_v2_236b,
    )
}


def reduce_config(cfg: ArchConfig, *, n_layers=2, d_model=128, n_heads=4,
                  d_ff=256, vocab=512) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    head_dim = d_model // n_heads
    n_kv = min(cfg.n_kv_heads, n_heads) if cfg.n_kv_heads > 1 else 1
    over = {}
    if cfg.mla:
        over["mla"] = {"kv_lora": 64, "qk_nope": head_dim, "qk_rope": 16,
                       "v_dim": head_dim}
    if cfg.moe:
        over["moe"] = dict(cfg.moe, n_routed=8, top_k=2, n_shared=1,
                           d_ff_expert=64, first_dense_layers=min(
                               1, cfg.moe.get("first_dense_layers", 0)),
                           d_ff_dense=d_ff)
    if cfg.ssm:
        over["ssm"] = {"d_state": 16, "headdim": 32,
                       "expand": cfg.ssm.get("expand", 2)}
    if cfg.hybrid:
        over["hybrid"] = {"attn_every": 2}
        n_layers = 4
    if cfg.enc:
        over["enc"] = {"enc_layers": 2, "enc_len": 64}
    if cfg.rope == "mrope":
        over["mrope_sections"] = (head_dim // 4, head_dim // 8, head_dim // 8)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_kv, head_dim=head_dim, d_ff=d_ff,
        vocab=vocab, **over)


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "reduce_config"]
