"""Plain PyTorch versions of the port's kernels: the ground truth each CUDA
kernel is held against, and what a wrapper runs on CPU tensors.

The prefix ops keep the JAX package's shift-doubling order
(`repro/kernels/ref.py`), so float32 sums associate as the reference's do.
The attention and norm versions compute in float32 and return the input's
type, as the reference's oracles do; the attention ones also take grouped
KV heads (Hq = G * Hkv, query head h reads KV head h // G), which is the
reference's function at G = 1.  The two scans return their final state
beside their output and take an initial one (the extension the model path
needs, see `repro_torch.kernels.ssd_scan`); at a zero initial state the
output is the reference's function.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30

# Tolerances (rtol = atol) at which a kernel is held against its plain
# version on the card. Scans: the reference's 2e-4 (tests/test_kernels.py:
# 82-109) for float32 outputs and for the float32 states; in bfloat16 both
# versions compute in float32 from the same bf16 inputs and round the
# output once to bf16 (relative 2**-8), so the output is held at the bf16
# tolerance 2e-2. moe_gemm: the reference's (tests/test_kernels.py:64-67).
SCAN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
STATE_TOL = 2e-4
MOE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis by shift-doubling."""
    k = 1
    w = x.shape[-1]
    while k < w:
        pad = x.new_zeros(x.shape[:-1] + (k,))
        x = x + torch.cat([pad, x[..., :-k]], dim=-1)
        k *= 2
    return x


def prefix_max(x: torch.Tensor, identity: float = NEG) -> torch.Tensor:
    """Inclusive prefix max over the last axis by shift-doubling."""
    k = 1
    w = x.shape[-1]
    while k < w:
        pad = x.new_full(x.shape[:-1] + (k,), identity)
        x = torch.maximum(x, torch.cat([pad, x[..., :-k]], dim=-1))
        k *= 2
    return x


def serialize_prefix_ref(free0: torch.Tensor, release: torch.Tensor,
                         dur: torch.Tensor):
    """FCFS prefix-serialization of independent resources over ordered items.

    ``free0``: (..., R) — time each resource becomes available; ``release``/
    ``dur``: (..., R, W) — per-item earliest start and occupancy duration on
    its resource, in FCFS service order along the last axis. Implements the
    queue recurrence ``f_k = max(f_{k-1}, r_k) + d_k`` (``f_0 = free0``) in
    closed form: with ``S_k = cumsum(d)`` the recurrence unrolls to
    ``f_k = S_k + max(free0, cummax_k(r_k - S_{k-1}))``. Items not on a
    resource are encoded as ``d = 0, r = -1e30``. Returns ``(finish (..., R,
    W), new_free (..., R))``.
    """
    s = prefix_sum(dur)
    g = release - (s - dur)
    run = torch.maximum(prefix_max(g), free0[..., None])
    fin = s + run
    return fin, fin[..., -1]


def _grouped_scores(q, k):
    """float32 scores of q (B, Hq, S, D) against k (B, Hkv, T, D), scaled by
    1/sqrt(D), as (B, Hkv, G, S, T)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    qg = q.float().reshape(B, Hkv, Hq // Hkv, S, D)
    return torch.einsum("bhgsd,bhtd->bhgst", qg, k.float()) / math.sqrt(D)


def _softmax_attention(q, k, v, causal: bool, diagonal: int):
    """Naive softmax attention, the causal mask `tril(diagonal)`."""
    B, Hq, S, D = q.shape
    T = k.shape[2]
    s = _grouped_scores(q, k)
    if causal:
        mask = torch.ones(S, T, dtype=torch.bool,
                          device=q.device).tril(diagonal)
        s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.float())
    return out.reshape(B, Hq, S, v.shape[-1]).to(q.dtype)


def flash_attention_ref(q, k, v, causal: bool = True):
    """q: (B,Hq,S,D); k,v: (B,Hkv,T,D) -> (B,Hq,S,D). Naive softmax
    attention; the causal mask is the reference oracle's `tril(k=T-S)`,
    which aligns it bottom-right: the oracle at S = T only."""
    return _softmax_attention(q, k, v, causal, k.shape[2] - q.shape[2])


def flash_attention_top_left_ref(q, k, v, causal: bool = True):
    """As `flash_attention_ref`, with the causal mask aligned top-left
    (query i sees keys j <= i, so rows i >= T see every key), as the TPU
    kernel (`repro/kernels/flash_attention.py:44-47`), both CUDA kernels and
    `models.layers.blocked_attention` align it: the plain version for
    causal S != T. At S = T the two masks are one."""
    return _softmax_attention(q, k, v, causal, 0)


def decode_attention_ref(q, k, v, cur_len):
    """q: (B,Hq,D); k,v: (B,Hkv,T,D); valid positions < cur_len."""
    B, Hq, D = q.shape
    T = k.shape[2]
    s = _grouped_scores(q[:, :, None], k)[..., 0, :]        # (B,Hkv,G,T)
    valid = torch.arange(T, device=q.device) < cur_len
    s = torch.where(valid, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v.float())
    return out.reshape(B, Hq, v.shape[-1]).to(q.dtype)


def moe_gemm_ref(x, w):
    """Capacity-layout grouped GEMM. x: (E,C,K); w: (E,K,N) -> (E,C,N)."""
    return torch.einsum("eck,ekn->ecn", x.float(), w.float()).to(x.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def ssd_scan_ref(x, dt, A, Bm, Cm, initial_state=None):
    """Per-token SSD recurrence (see models.ssm.ssd_scan_oracle).

    x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm,Cm: (B,S,N); initial_state:
    float32 (B,H,P,N) or None -> (y (B,S,H,P), final state (B,H,P,N))."""
    from repro_torch.models.ssm import ssd_scan_oracle
    return ssd_scan_oracle(x, dt, A, Bm, Cm, initial_state)


def rwkv6_scan_ref(r, k, v, logw, u, initial_state=None):
    """Per-token RWKV6 recurrence (see models.rwkv.rwkv6_scan_oracle) ->
    (o (B,S,H,V), final state (B,H,K,V))."""
    from repro_torch.models.rwkv import rwkv6_scan_oracle
    return rwkv6_scan_oracle(r, k, v, logw, u, initial_state)
