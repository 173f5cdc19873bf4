"""Public wrappers of the port's serving kernels, with the names and defaults
of the JAX package's `repro/kernels/ops.py`.

Where the reference resolves `interpret` from the backend
(`_default_interpret`), these resolve from the tensors' device: CPU tensors
go to the plain PyTorch version, CUDA tensors go to the hand-written kernel
or raise.  The block sizes are the TPU kernels' tiles; they are accepted so
that calls carry over, and the CUDA kernels choose their own tiles and take
any S and T.  `grouped_expert_gemm`, `mamba2_ssd` and `rwkv6_wkv` arrive
with their kernels (ROADMAP queue 2, items 5-7).
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_fwd


def flash_attention(q, k, v, *, causal=True, block_q=256, block_kv=256):
    """q: (B,H,S,D); k,v: (B,Hkv,T,D) -> (B,H,S,D)."""
    return flash_attention_fwd(q, k, v, causal=causal)


def decode_attention(q, k, v, cur_len, *, block_kv=512):
    """q: (B,H,D); k,v: (B,Hkv,T,D); positions >= cur_len masked."""
    return decode_attention_fwd(q, k, v, cur_len)


def rmsnorm(x, scale, *, eps=1e-5, block_rows=256):
    """x: (..., D); scale: (D,)."""
    return rmsnorm_fwd(x, scale, eps=eps)
