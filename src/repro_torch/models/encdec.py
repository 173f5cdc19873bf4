"""Whisper-style encoder-decoder parameter specs, from the JAX package's
`repro/models/encdec.py`.  The encoder and decoder stacks are ROADMAP
queue 1, item 11.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import gelu_mlp_specs
from repro_torch.models.module import ParamSpec, stack_specs


def _ln_specs(cfg):
    return {"scale": ParamSpec((cfg.d_model,), cfg.dtype, (None,), init="ones"),
            "bias": ParamSpec((cfg.d_model,), cfg.dtype, (None,), init="zeros")}


def enc_layer_specs(cfg: ArchConfig):
    return {
        "ln1": _ln_specs(cfg),
        "attn": attn.gqa_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.dtype),
        "ln2": _ln_specs(cfg),
        "ffn": gelu_mlp_specs(cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def dec_layer_specs(cfg: ArchConfig):
    return {
        "ln1": _ln_specs(cfg),
        "self": attn.gqa_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.dtype),
        "lnx": _ln_specs(cfg),
        "cross": attn.gqa_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, cfg.dtype),
        "ln2": _ln_specs(cfg),
        "ffn": gelu_mlp_specs(cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def whisper_param_specs(cfg: ArchConfig):
    enc_layers = cfg.enc["enc_layers"]
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), cfg.dtype,
                           ("vocab", None), scale=0.02),
        "enc_layers": stack_specs(enc_layer_specs(cfg), enc_layers),
        "enc_norm": _ln_specs(cfg),
        "dec_layers": stack_specs(dec_layer_specs(cfg), cfg.n_layers),
        "dec_norm": _ln_specs(cfg),
    }
