"""Flash attention forward: the wrapper of the CUDA kernel
`csrc/flash_attention.cu`, which replaces the JAX package's Pallas kernel
`repro/kernels/flash_attention.py:flash_attention_fwd`.

A CPU tensor goes to the plain version
(`repro_torch.kernels.ref.flash_attention_ref`); a CUDA tensor goes to the
kernel, or the wrapper raises.  `flash_attention_fwd.launches` counts the
kernel's launches, and nothing else.

The kernel keeps p in float32 and normalises after the PV sum, as the TPU
kernel does. The model's plain `blocked_attention`
(`repro_torch.models.layers`) rounds p to v's type before the PV product,
so in bfloat16 the two differ by that rounding.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import (check, cuda_index, dtype_code,
                                       load_library, stream_of)
from repro_torch.kernels.ref import flash_attention_ref


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """``q``: (B, Hq, S, D); ``k``, ``v``: (B, Hkv, T, D) with Hq = G * Hkv
    -> (B, Hq, S, D) in q's type, laid out as q is.  Any strides work on
    CUDA as long as the D axis is contiguous, so the model's (B, S, H, D)
    activations pass as ``x.transpose(1, 2)``.  Causal attention needs
    S == T: for S != T the mask's alignment is in dispute between the
    reference's kernel (top-left) and its oracle (bottom-right)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if causal and S != T:
        raise ValueError(f"causal attention needs S == T, not S={S}, T={T}")
    index = cuda_index(q, k, v)
    if index < 0:
        return flash_attention_ref(q, k, v, causal=causal)
    code = dtype_code("q", q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v types differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if D > 256 or min(q.stride(-1), k.stride(-1), v.stride(-1)) != 1:
        raise ValueError("the D axis must be contiguous and D <= 256")
    if q.numel() == 0 or T == 0:
        raise ValueError("flash_attention needs B, Hq, S, T and D >= 1")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"at most 65535 batches and heads, not {B}, {Hq}")
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2), out.stride(0),
        out.stride(1), out.stride(2))
    lib = load_library("flash_attention")
    err = lib.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), B, Hq, Hkv, S, T, D, int(causal),
        1.0 / math.sqrt(D), code, index, stream_of(index))
    check(lib, err, "flash_attention")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
