"""Public wrappers of the port's serving kernels, with the names and defaults
of the JAX package's `repro/kernels/ops.py`.

Where the reference resolves `interpret` from the backend
(`_default_interpret`), these resolve from the tensors' device: CPU tensors
go to the plain PyTorch version, CUDA tensors go to the hand-written kernel
or raise.  The block sizes are the TPU kernels' tiles; they are accepted so
that calls carry over, and the CUDA kernels choose their own tiles and take
any S and T (and the expert GEMM any C, K and N).  The two scans return
their output only, as the reference's do; their wrappers
(`repro_torch.kernels.ssd_scan`, `repro_torch.kernels.rwkv6_scan`) also
return the final state, for the model path.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.rmsnorm import rmsnorm_fwd
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.ssd_scan import ssd_scan


def flash_attention(q, k, v, *, causal=True, block_q=256, block_kv=256):
    """q: (B,H,S,D); k,v: (B,Hkv,T,D) -> (B,H,S,D)."""
    return flash_attention_fwd(q, k, v, causal=causal)


def decode_attention(q, k, v, cur_len, *, block_kv=512):
    """q: (B,H,D); k,v: (B,Hkv,T,D); positions >= cur_len masked."""
    return decode_attention_fwd(q, k, v, cur_len)


def grouped_expert_gemm(x, w, *, block_m=128, block_n=128, block_k=128):
    """x: (E,C,K); w: (E,K,N) -> (E,C,N)."""
    return moe_gemm(x, w)


def rmsnorm(x, scale, *, eps=1e-5, block_rows=256):
    """x: (..., D); scale: (D,)."""
    return rmsnorm_fwd(x, scale, eps=eps)


def mamba2_ssd(x, dt, A, Bm, Cm, *, chunk=64):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm,Cm: (B,S,N) -> y (B,S,H,P)."""
    return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)[0]


def rwkv6_wkv(r, k, v, logw, u, *, chunk=32):
    """r,k,logw: (B,S,H,K); v: (B,S,H,V); u: (H,K) -> o (B,S,H,V)."""
    return rwkv6_scan(r, k, v, logw, u, chunk=chunk)[0]
