"""Mamba2 / SSD parameter specs, from the JAX package's
`repro/models/ssm.py`.  The layer itself (chunked SSD, the scan oracle and
the decode step) is ROADMAP queue 1, item 11; its kernel is queue 2, item 5.
"""
from __future__ import annotations

import torch

from repro_torch.models.module import ParamSpec

CONV_W = 4  # causal short conv width


def mamba2_specs(d_model: int, d_state: int = 64, headdim: int = 64,
                 expand: int = 2, dtype=torch.bfloat16):
    d_inner = expand * d_model
    H = d_inner // headdim
    d_conv = d_inner + 2 * d_state   # conv over [x, B, C]
    return {
        "in_proj": ParamSpec((d_model, 2 * d_inner + 2 * d_state + H), dtype,
                             ("embed", "mlp")),
        "conv_w": ParamSpec((CONV_W, d_conv), dtype, (None, "mlp"), scale=0.5),
        "conv_b": ParamSpec((d_conv,), dtype, (None,), init="zeros"),
        "A_log": ParamSpec((H,), torch.float32, (None,), init="zeros"),
        "D": ParamSpec((H,), torch.float32, (None,), init="ones"),
        "dt_bias": ParamSpec((H,), torch.float32, (None,), init="zeros"),
        "norm": ParamSpec((d_inner,), dtype, (None,), init="ones"),
        "out_proj": ParamSpec((d_inner, d_model), dtype, ("mlp", "embed")),
    }
