"""Flash attention forward: the wrapper of the CUDA kernel
`csrc/flash_attention.cu`, which replaces the JAX package's Pallas kernel
`repro/kernels/flash_attention.py:flash_attention_fwd`.

A CPU tensor goes to the plain version
(`repro_torch.kernels.ref.flash_attention_ref`, and for causal S != T
`flash_attention_top_left_ref`); a CUDA tensor goes to the kernel, or the
wrapper raises.  `flash_attention_fwd.launches` counts the
kernel's launches, and nothing else.

Two kernels take a CUDA call, and `variant` names the one, openly by dtype,
D and alignment: "mma" (`flash_attention_kernel_mma`, bf16 tensor cores fed
by a cp.async K/V stream) for bfloat16 with D a multiple of 16 up to 128,
every B, H and S|T stride of q, k and v a multiple of 8 elements and the
three 16-byte aligned, which every serving shape is, in the model's
transposed views too; "fma" (`flash_attention_kernel_fma`, CUDA cores) for
float32 and every other call.

Both kernels keep p at float32 precision and normalise after the PV sum, as
the TPU kernel does (the tensor-core kernel multiplies V by p split into two
bfloat16 parts). The model's plain `blocked_attention`
(`repro_torch.models.layers`) rounds p to v's type before the PV product,
so in bfloat16 the two differ by that rounding.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import (check, cuda_index, dtype_code,
                                       load_library, stream_of)
from repro_torch.kernels.ref import (flash_attention_ref,
                                     flash_attention_top_left_ref)


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a call on ``q`` (B, Hq, S, D) and ``k``, ``v`` (B, Hkv, T,
    D) of one type runs: "mma" or "fma" (see the module's docstring)."""
    D = q.shape[-1]
    if q.dtype != torch.bfloat16 or D % 16 or D > 128:
        return "fma"
    if any(t.stride(i) % 8 for t in (q, k, v) for i in range(3)):
        return "fma"
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        return "fma"
    return "mma"


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """``q``: (B, Hq, S, D); ``k``, ``v``: (B, Hkv, T, D) with Hq = G * Hkv
    -> (B, Hq, S, D) in q's type, laid out as q is.  Any strides work on
    CUDA as long as the D axis is contiguous, so the model's (B, S, H, D)
    activations pass as ``x.transpose(1, 2)``.  The causal mask is aligned
    top-left, as the TPU kernel aligns it: query i sees keys j <= i, so for
    S > T the rows i >= T see every key."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    index = cuda_index(q, k, v)
    if index < 0:
        plain = flash_attention_top_left_ref if causal and S != T \
            else flash_attention_ref
        return plain(q, k, v, causal=causal)
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
        1.0 / math.sqrt(D), code, variant(q, k, v) == "mma", index,
        stream_of(index))
    check(lib, err, "flash_attention")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
