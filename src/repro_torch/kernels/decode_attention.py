"""Decode attention: the wrapper of the CUDA kernel `csrc/decode_attention.cu`,
which replaces the JAX package's Pallas kernel
`repro/kernels/decode_attention.py:decode_attention_fwd`.

A CPU tensor goes to the plain version
(`repro_torch.kernels.ref.decode_attention_ref`); a CUDA tensor goes to the
kernel, or the wrapper raises.  `decode_attention_fwd.launches` counts the
kernel's launches, and nothing else.

Two kernels take a CUDA call, and `variant` names the one, openly by D and
alignment: "split" (`decode_attention_kernel_split`: one thread-block
cluster per KV head, each block a share of the cache for all the head's
query heads, merged across the cluster in the same launch) for float32 and
bfloat16 with D a multiple of 8 and k and v 16-byte aligned with B, H and T
strides that are multiples of a 16-byte vector, which every serving shape
is; "head" (`decode_attention_kernel_head`, one block per query head) for
every other call.

Both kernels keep p in float32 and normalise after the PV sum, as the TPU
kernel does. The model's plain `decode_attention`
(`repro_torch.models.layers`) normalises first and rounds p to the cache's
type before the PV product, so in bfloat16 the two differ by that rounding.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import (check, cuda_index, dtype_code,
                                       load_library, stream_of)
from repro_torch.kernels.ref import decode_attention_ref


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a call on ``q`` (B, Hq, D) and ``k``, ``v`` (B, Hkv, T, D)
    of one type runs: "split" or "head" (see the module's docstring)."""
    per_vector = 16 // k.element_size()
    if q.shape[-1] % 8 or (k.data_ptr() | v.data_ptr()) % 16:
        return "head"
    if any(t.stride(i) % per_vector for t in (k, v) for i in range(3)):
        return "head"
    return "split"


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cur_len: int) -> torch.Tensor:
    """``q``: (B, Hq, D); ``k``, ``v``: (B, Hkv, T, D) with Hq = G * Hkv;
    positions ``>= cur_len`` (a Python int) are masked -> (B, Hq, D) in q's
    type.  Any strides work on CUDA as long as the D axis is contiguous, so
    the model's (B, T, Hkv, D) cache passes as ``cache.transpose(1, 2)``."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Hq, D = q.shape
    _, Hkv, T, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    cur_len = int(cur_len)
    index = cuda_index(q, k, v)
    if index < 0:
        return decode_attention_ref(q, k, v, cur_len)
    code = dtype_code("q", q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v types differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if D > 256 or min(q.stride(-1), k.stride(-1), v.stride(-1)) != 1:
        raise ValueError("the D axis must be contiguous and D <= 256")
    if q.numel() == 0 or T == 0:
        raise ValueError("decode_attention needs B, Hq, T and D >= 1")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        q.stride(0), q.stride(1), 0, k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
        0)
    lib = load_library("decode_attention")
    err = lib.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), B, Hq, Hkv, T, D, cur_len,
        1.0 / math.sqrt(D), code, variant(q, k, v) == "split", index,
        stream_of(index))
    check(lib, err, "decode_attention")
    decode_attention_fwd.launches += 1
    return out


decode_attention_fwd.launches = 0
