"""RWKV-6 parameter specs, from the JAX package's `repro/models/rwkv.py`.
The layer itself (chunked WKV, the oracle and the decode step) is ROADMAP
queue 1, item 11; its kernel is queue 2, item 6.
"""
from __future__ import annotations

import torch

from repro_torch.models.module import ParamSpec


def rwkv6_specs(d_model: int, head_dim: int = 64, d_ff: int | None = None,
                dtype=torch.bfloat16):
    H = d_model // head_dim
    d_ff = d_ff or int(3.5 * d_model)
    lora = max(32, d_model // 16)
    return {
        "tm": {  # time mix
            "mu_r": ParamSpec((d_model,), dtype, (None,), init="zeros"),
            "mu_k": ParamSpec((d_model,), dtype, (None,), init="zeros"),
            "mu_v": ParamSpec((d_model,), dtype, (None,), init="zeros"),
            "mu_w": ParamSpec((d_model,), dtype, (None,), init="zeros"),
            "mu_g": ParamSpec((d_model,), dtype, (None,), init="zeros"),
            "Wr": ParamSpec((d_model, d_model), dtype, ("embed", "heads")),
            "Wk": ParamSpec((d_model, d_model), dtype, ("embed", "heads")),
            "Wv": ParamSpec((d_model, d_model), dtype, ("embed", "heads")),
            "Wg": ParamSpec((d_model, d_model), dtype, ("embed", "heads")),
            "Wo": ParamSpec((d_model, d_model), dtype, ("heads", "embed")),
            # data-dependent decay: w = exp(-softplus(lora path)) per channel
            "w_lora_a": ParamSpec((d_model, lora), dtype, ("embed", None)),
            "w_lora_b": ParamSpec((lora, d_model), dtype, (None, "heads")),
            "w_bias": ParamSpec((d_model,), torch.float32, (None,), init="zeros"),
            "u": ParamSpec((H, head_dim), torch.float32, (None, None),
                           init="zeros"),
            "ln_out": ParamSpec((d_model,), dtype, (None,), init="ones"),
        },
        "cm": {  # channel mix
            "mu_k": ParamSpec((d_model,), dtype, (None,), init="zeros"),
            "Wk": ParamSpec((d_model, d_ff), dtype, ("embed", "mlp")),
            "Wv": ParamSpec((d_ff, d_model), dtype, ("mlp", "embed")),
            "Wr": ParamSpec((d_model, d_model), dtype, ("embed", None)),
        },
    }
