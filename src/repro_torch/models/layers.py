"""Shared model layers, the dense part of the JAX package's
`repro/models/layers.py`: norms, rotary embeddings, blocked
(FlashAttention-style memory-efficient) attention, decode attention and the
GLU / GELU MLPs, plus the MoE parameter specs.

Everything is pure-functional over param dicts produced from ParamSpec trees
(see module.py). Attention math accumulates in fp32; weights/activations are
bf16 by default. Mixed-precision products of the reference
(`preferred_element_type=F32` on bf16 operands) upcast the operands to
float32 first: a bf16 x bf16 product is exact in float32.

`kernels=True` runs `rmsnorm`, `blocked_attention` and `decode_attention`
through the port's hand-written kernels (`repro_torch.kernels`), which
compute the TPU kernels' functions; each wrapper's docstring names how that
differs from the plain math here. `apply_mrope`, `decode_attention_kv_sharded`
and `moe_ffn` are not ported yet (ROADMAP queue 1, items 8 and 13).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_fwd
from repro_torch.models.module import ParamSpec

F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-5, *, kernels: bool = False):
    if kernels:
        return rmsnorm_fwd(x, scale, eps=eps)
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 1e4, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                # (D/2,)
    angles = positions[..., None].to(F32) * freqs                # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# blocked (memory-efficient) attention — the plain path; the flash kernel
# (repro_torch.kernels.flash_attention) is its hand-written twin.
# ---------------------------------------------------------------------------

def blocked_attention(q, k, v, *, causal: bool = True, block_q: int = 512,
                      block_kv: int = 1024, kernels: bool = False):
    """Online-softmax attention over KV blocks (O(S) memory).

    q: (B, S, Hq, D); k, v: (B, T, Hkv, D) with Hq % Hkv == 0.  (The
    reference's additive `bias` argument has no caller there and is left
    out.)
    """
    if kernels:
        out = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)
    B, S, Hq, D = q.shape
    _, T, Hkv, _ = k.shape
    Dv = v.shape[-1]                     # may differ from D (e.g. MLA)
    G = Hq // Hkv
    bq = min(block_q, S)
    bk = min(block_kv, T)
    # pad ragged sequence lengths to full blocks; padded kv positions are
    # masked below, padded q rows are sliced off
    S_orig, T_orig = S, T
    pad_q = (-S) % bq
    pad_k = (-T) % bk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        S += pad_q
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        T += pad_k
    nq, nk = S // bq, T // bk
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qh = q.reshape(B, S, Hkv, G, D)

    outs = []
    for qi in range(nq):
        q_blk = qh[:, qi * bq:(qi + 1) * bq].float()
        qpos = qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, Hkv, G, bq), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((B, Hkv, G, bq), dtype=F32, device=dev)
        acc = torch.zeros((B, Hkv, G, bq, Dv), dtype=F32, device=dev)
        for kj in range(nk):
            k_blk = k[:, kj * bk:(kj + 1) * bk]
            v_blk = v[:, kj * bk:(kj + 1) * bk]
            kpos = kj * bk + torch.arange(bk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk,
                             k_blk.float()) * scale
            if pad_k:
                s = torch.where(kpos[None, :] < T_orig, s, NEG_INF)
            if causal:
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v_blk.dtype).float(), v_blk.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]       # (B,Hkv,G,bq,D)
        outs.append(torch.movedim(out, 3, 1).to(q.dtype))     # (B,bq,Hkv,G,D)
    out = torch.cat(outs, dim=1).reshape(B, S, Hq, Dv)
    return out[:, :S_orig] if pad_q else out


def decode_attention(q, k_cache, v_cache, cur_len: int, *,
                     kernels: bool = False):
    """Single-token decode: q (B, 1, Hq, D) against a KV cache (B, T, Hkv, D)
    of which the first `cur_len` positions are valid."""
    B, _, Hq, D = q.shape
    _, T, Hkv, _ = k_cache.shape
    if kernels:
        out = decode_attention_fwd(q[:, 0], k_cache.transpose(1, 2),
                                   v_cache.transpose(1, 2), cur_len)
        return out.reshape(B, 1, Hq, D)
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k_cache.float()) / math.sqrt(D)
    valid = torch.arange(T, device=q.device) < cur_len
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP / GLU
# ---------------------------------------------------------------------------

def glu_mlp_specs(d_model: int, d_ff: int, dtype=torch.bfloat16):
    return {
        "gate": ParamSpec((d_model, d_ff), dtype, ("embed", "mlp")),
        "up": ParamSpec((d_model, d_ff), dtype, ("embed", "mlp")),
        "down": ParamSpec((d_ff, d_model), dtype, ("mlp", "embed")),
    }


def glu_mlp(params, x):
    h = F.silu(x @ params["gate"]) * (x @ params["up"])
    return h @ params["down"]


def gelu_mlp_specs(d_model: int, d_ff: int, dtype=torch.bfloat16):
    return {
        "in": ParamSpec((d_model, d_ff), dtype, ("embed", "mlp")),
        "in_b": ParamSpec((d_ff,), dtype, (None,), init="zeros"),
        "out": ParamSpec((d_ff, d_model), dtype, ("mlp", "embed")),
        "out_b": ParamSpec((d_model,), dtype, (None,), init="zeros"),
    }


def gelu_mlp(params, x):
    h = F.gelu(x @ params["in"] + params["in_b"], approximate="tanh")
    return h @ params["out"] + params["out_b"]


# ---------------------------------------------------------------------------
# fine-grained MoE (DeepSeekMoE) parameter specs; the layer itself
# (moe_ffn) is ROADMAP queue 1, item 8.
# ---------------------------------------------------------------------------

def moe_specs(d_model: int, d_ff_expert: int, n_routed: int, n_shared: int,
              dtype=torch.bfloat16):
    specs = {
        "router": ParamSpec((d_model, n_routed), torch.float32,
                            ("embed", None), scale=0.02),
        "gate": ParamSpec((n_routed, d_model, d_ff_expert), dtype,
                          (None, "embed", "mlp")),
        "up": ParamSpec((n_routed, d_model, d_ff_expert), dtype,
                        (None, "embed", "mlp")),
        "down": ParamSpec((n_routed, d_ff_expert, d_model), dtype,
                          (None, "mlp", "embed")),
    }
    if n_shared:
        specs["shared"] = glu_mlp_specs(d_model, d_ff_expert * n_shared, dtype)
    return specs
