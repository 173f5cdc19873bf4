"""Shared model layers, the dense part of the JAX package's
`repro/models/layers.py`: norms, rotary embeddings (RoPE and Qwen2-VL's
M-RoPE), blocked
(FlashAttention-style memory-efficient) attention, decode attention and the
GLU / GELU MLPs, and the fine-grained MoE FFN.

Everything is pure-functional over param dicts produced from ParamSpec trees
(see module.py). Attention math accumulates in fp32; weights/activations are
bf16 by default. Mixed-precision products of the reference
(`preferred_element_type=F32` on bf16 operands) upcast the operands to
float32 first: a bf16 x bf16 product is exact in float32.

`kernels=True` runs `rmsnorm`, `blocked_attention`, `decode_attention` and
the expert products of `moe_ffn` through the port's hand-written kernels
(`repro_torch.kernels`), which compute the TPU kernels' functions; each
wrapper's docstring names how that differs from the plain math here.
`decode_attention_kv_sharded` is not ported yet (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.moe_gemm import moe_gemm
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


def _rotate(x, angles):
    """Rotate the halves of x's last axis by `angles` (..., S, D/2), in
    float32, one angle for every head."""
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                # (D/2,)
    return _rotate(x, positions[..., None].to(F32) * freqs)     # (..., S, D/2)


def apply_mrope(x, positions_thw, sections=(16, 24, 24), theta: float = 1e6):
    """Qwen2-VL M-RoPE: head_dim/2 frequency slots split into (t, h, w)
    sections, each rotated by its own position stream.

    x: (B, S, H, D); positions_thw: (3, B, S).
    """
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {d // 2}")
    freqs = rope_frequencies(d, theta, x.device)                # (D/2,)
    # each section of slots turns by its own stream: t, h or w
    angles = [p[..., None] * f for p, f in
              zip(positions_thw.to(F32), torch.split(freqs, list(sections)))]
    return _rotate(x, torch.cat(angles, dim=-1))                # (B, S, D/2)


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
# fine-grained MoE (DeepSeekMoE): shared experts + top-k routed experts
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


def _ragged_dot(xs, w, group_sizes):
    """`jax.lax.ragged_dot` as a loop over experts: rows of `xs` (sorted by
    expert) in consecutive groups of `group_sizes`, each times its w[e]."""
    out = xs.new_empty((xs.shape[0], w.shape[-1]))
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        out[start:start + n] = xs[start:start + n] @ w[e]
        start += n
    return out


def moe_ffn(params, x, *, top_k: int, impl: str = "capacity",
            capacity_factor: float = 1.25, kernels: bool = False):
    """x: (B, S, D) -> (out, aux_loss). Token-local routing over one device
    (the reference shards experts across a mesh; its collectives are
    ROADMAP queue 1, item 13).

    impl='capacity' (default): GShard-style fixed-capacity scatter/gather
    dispatch + batched expert GEMMs; tokens beyond an expert's capacity are
    dropped. A token's rank inside its expert comes from a stable argsort,
    as the reference's `jnp.argsort`, so the same tokens drop.
    `kernels=True` runs the three expert GEMMs through the CUDA kernel
    (`repro_torch.kernels.moe_gemm`).
    impl='ragged': sort + grouped GEMM (a loop over experts in place of
    `jax.lax.ragged_dot`) — exact (no drops). It has no kernel, so it
    raises with `kernels=True`.
    """
    B, S, D = x.shape
    E = params["router"].shape[1]
    wg, wu, wd = params["gate"], params["up"], params["down"]
    n = B * S
    xf = x.reshape(n, D)
    logits = xf.float() @ params["router"]                     # (n, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, top_k, dim=-1)              # (n, k)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    flat_e = topi.reshape(-1)                                  # (n*k,) token-major
    group_sizes = torch.bincount(flat_e, minlength=E)

    if impl == "capacity":
        gemm = moe_gemm if kernels else (
            lambda a, b: torch.einsum("ecd,edf->ecf", a, b))
        C = max(8, int(math.ceil(n * top_k * capacity_factor / E)))
        # rank of each (token, slot) within its expert, via a stable argsort
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        idx = torch.arange(n * top_k, device=x.device)
        is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                              sorted_e[1:] != sorted_e[:-1]])
        group_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
        rank = torch.empty_like(flat_e)
        rank[order] = idx - group_start
        ok = rank < C
        rank_c = torch.clamp_max(rank, C - 1)
        tok = idx // top_k
        contrib = torch.where(ok[:, None], xf[tok], 0)
        buf = xf.new_zeros((E, C, D)).index_put_((flat_e, rank_c), contrib,
                                                 accumulate=True)
        h = F.silu(gemm(buf, wg)) * gemm(buf, wu)              # (E, C, F)
        y_buf = gemm(h, wd)
        y = y_buf[flat_e, rank_c] * ok.to(y_buf.dtype)[:, None]
        w_slot = topv.reshape(-1).float()
        out = torch.sum((y.float() * w_slot[:, None]).reshape(n, top_k, D),
                        dim=1)
    elif impl == "ragged":
        if kernels:
            raise ValueError("moe_ffn(impl='ragged') has no kernel; "
                             "pass kernels=False")
        order = torch.argsort(flat_e, stable=True)
        tok = order // top_k
        xs = xf[tok]                                           # (n*k, D) sorted
        h = F.silu(_ragged_dot(xs, wg, group_sizes)) * \
            _ragged_dot(xs, wu, group_sizes)
        y = _ragged_dot(h.to(xs.dtype), wd, group_sizes)
        w_sorted = topv.reshape(-1)[order].float()
        out = torch.zeros((n, D), dtype=F32, device=x.device).index_add_(
            0, tok, y.float() * w_sorted[:, None])
    else:
        raise ValueError(f"unknown MoE impl {impl!r}")

    if "shared" in params:
        sp = params["shared"]
        hs = F.silu(xf @ sp["gate"]) * (xf @ sp["up"])
        out = out + (hs @ sp["down"]).float()
    # switch-style load-balance aux loss
    frac = group_sizes.float() / max(n * top_k, 1)
    imp = probs.mean(dim=0)
    aux = E * torch.sum(frac * imp)
    return out.to(x.dtype).reshape(B, S, D), aux
