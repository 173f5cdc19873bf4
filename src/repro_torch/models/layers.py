"""Shared model layers, the dense part of the JAX package's
`repro/models/layers.py`: norms, rotary embeddings (RoPE, Qwen2-VL's
M-RoPE and DeepSeek-V2's YaRN frequencies), blocked
(FlashAttention-style memory-efficient) attention, decode attention and the
GLU / GELU MLPs, and the fine-grained MoE FFN, whose router may keep
DeepSeek-V2's groups of experts and scale its weights (`route`).  The
MoE's capacity path
moves rows between tokens and expert slots through a slot table
(`moe_local`): the dispatch and the combine are gathers, each the other's
backward, and nothing accumulates; while a profiler records, it counts
the rows routed and dropped and the E x C slots (`moe.slots`).

Everything is pure-functional over param dicts produced from ParamSpec trees
(see module.py). Attention math accumulates in fp32; weights/activations are
bf16 by default. Mixed-precision products of the reference
(`preferred_element_type=F32` on bf16 operands) upcast the operands to
float32 first: a bf16 x bf16 product is exact in float32.  On the card
`matmul_f32` (the head's logits, the blocked attention's two products)
runs them on tensor cores with bf16 operands and float32 sums and output;
the blocked attention's causal path computes no block pair that the mask
empties.

`kernels=True` runs `rmsnorm`, `blocked_attention`, `decode_attention` and
the expert products of `moe_ffn` through the port's hand-written kernels
(`repro_torch.kernels`), which compute the TPU kernels' functions; each
wrapper's docstring names how that differs from the plain math here.

The reference's two `shard_map` regions run over a `sharding.rules.Mesh`
with `torch.distributed` collectives: `decode_attention_kv_sharded`
(flash-decoding split-KV over the ranks of `kv_axis`, plain PyTorch, as
the reference's is plain `jnp`) and `moe_ffn(mesh=)` (tokens split over
the data-parallel axes, each expert's d_ff over `model`, the output summed
over `model` in bf16); `moe_local` is the region's body on one rank's
block, which the decoder calls with its own layout.  `glu_mlp` and
`gelu_mlp` take `tp`, a mesh whose "model" ranks split d_ff (Megatron's
column- then row-parallel pair, one reduction at the end);
`rmsnorm_split` is RMSNorm over a row whose channels split over "model"
(Mamba2's gated norm and RWKV's `ln_out` on local heads).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.rmsnorm import rmsnorm_fwd
from repro_torch.models.module import ParamSpec
from repro_torch.obs.realtime import device_tracer
from repro_torch.sharding.collectives import (all_reduce, copy_to,
                                              mean_over, reduce_from, rows,
                                              sum_over)
from repro_torch.sharding.rules import all_gather, batch_axes

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


def rmsnorm_split(x, scale, tp, eps: float = 1e-5):
    """`rmsnorm` of rows split over `tp`'s "model" ranks: `x` holds this
    rank's channels of each row and `scale` their slice.  Each rank's
    float32 sum of squares sums over "model" (`sum_over`), so every rank
    divides by the whole row's mean; plain math on every device (the
    rmsnorm kernel normalises whole rows)."""
    xf = x.float()
    ss = sum_over(torch.sum(xf * xf, dim=-1, keepdim=True), tp, "model")
    var = ss / (x.shape[-1] * tp.size("model"))
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


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature m(s, a) = 0.1 a ln s + 1 (1 for s <= 1).

        >>> round(yarn_mscale(40, 0.707) ** 2, 4)
        1.5896
    """
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(head_dim: int, theta: float, scaling: dict) -> tuple:
    """(low, high): the frequency slots YaRN's ramp runs between, the
    correction dims of `beta_fast` (floored) and `beta_slow` (ceiled),
    clamped to [0, head_dim - 1].

        >>> yarn_range(64, 1e4, {"beta_fast": 32, "beta_slow": 1,
        ...                      "original_max_position_embeddings": 4096})
        (10, 23)
    """
    L0 = scaling["original_max_position_embeddings"]

    def corr(rotations):
        return head_dim * math.log(L0 / (rotations * 2 * math.pi)) / \
            (2 * math.log(theta))
    low = math.floor(corr(scaling["beta_fast"]))
    high = math.ceil(corr(scaling["beta_slow"]))
    return max(low, 0), min(high, head_dim - 1)


def yarn_frequencies(head_dim: int, theta: float, scaling: dict,
                     device=None):
    """YaRN's inverse frequencies (DeepSeek-V2's rotary embedding): the
    plain ones (`rope_frequencies`) below slot `low`, those divided by
    `factor` above `high`, a linear ramp between (`yarn_range`)."""
    extra = rope_frequencies(head_dim, theta, device)
    low, high = yarn_range(head_dim, theta, scaling)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=F32,
                                     device=device) - low) / (high - low),
                       0, 1)
    return extra / scaling["factor"] * ramp + extra * (1 - ramp)


def _rotate(x, angles, mscale: float = 1.0):
    """Rotate the halves of x's last axis by `angles` (..., S, D/2), in
    float32, one angle for every head; cos and sin times `mscale`."""
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 1e4, scaling: dict | None = None):
    """x: (..., S, H, D); positions: broadcastable to (..., S).  `scaling`
    (a config's `rope_scaling`, type "yarn") takes YaRN's frequencies
    and scales cos and sin by m(s, mscale) / m(s, mscale_all_dim)."""
    d = x.shape[-1]
    if scaling is None:
        freqs, mscale = rope_frequencies(d, theta, x.device), 1.0  # (D/2,)
    else:
        if scaling.get("type") != "yarn":
            raise ValueError(f"unknown rope_scaling {scaling.get('type')!r}")
        s = scaling["factor"]
        freqs = yarn_frequencies(d, theta, scaling, x.device)
        mscale = yarn_mscale(s, scaling.get("mscale", 1)) / \
            yarn_mscale(s, scaling.get("mscale_all_dim", 1))
    return _rotate(x, positions[..., None].to(F32) * freqs,     # (..., S, D/2)
                   mscale)


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

class _MatmulF32(torch.autograd.Function):
    """bf16 ``a`` (..., n, K) against the rows of bf16 ``b`` (..., m, K),
    float32 out (..., n, m): one `torch.mm` or, with a leading batch axis,
    `torch.bmm` with `out_dtype=`, which have no derivative.  The backward
    pass rounds the float32 output gradient to bf16 and runs bf16 products
    with float32 sums, rounded once to bf16: the gradient of the
    reference's einsum under the TPU's default precision (one bf16 pass a
    product)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a, b.mT, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ b if ctx.needs_input_grad[0] else None
        gb = g.mT @ a if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul_f32(a, b):
    """``a`` (n, K) or (batch, n, K) against the rows of ``b`` (m, K) or
    (batch, m, K) -> float32 (..., n, m), as the reference's
    `einsum(..., preferred_element_type=F32)`: bf16 operands, float32 sums,
    no rounding of the output to bf16.  On the card one tensor-core product
    with float32 output (`_MatmulF32`); elsewhere float32 operands, which
    hold bf16 values exactly."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return _MatmulF32.apply(a, b)
    return a.float() @ b.float().mT


def attention_dot(a, b):
    """`matmul_f32` for the blocked attention's two products, which a torch
    function mode sees whole: the dry run's recorder (`analysis.hlo`)
    counts their dots as attention tiles."""
    if has_torch_function((a, b)):
        return handle_torch_function(attention_dot, (a, b), a, b)
    return matmul_f32(a, b)


def blocked_attention(q, k, v, *, causal: bool = True, block_q: int = 512,
                      block_kv: int = 1024, kernels: bool = False,
                      scale: float | None = None):
    """Online-softmax attention over KV blocks (O(S) memory).

    q: (B, S, Hq, D); k, v: (B, T, Hkv, D) with Hq % Hkv == 0.  (The
    reference's additive `bias` argument has no caller there and is left
    out.)  `scale`: the scores' factor, 1 / sqrt(D) when None; the flash
    kernel (`kernels=True`) scales by 1 / sqrt(D) and refuses any other.

    Both products run through `attention_dot` on head-major operands: keys
    and values (B Hkv, T, D) once a call, a q block's G heads flattened into
    its rows (B Hkv, G bq, D).  Causal (row i sees keys j <= i, both
    counted from 0): a q block visits only the kv blocks that hold a key
    its last row sees, and masks only those that cross the diagonal.  Both
    are exact: block 0 makes every row's running max finite, so a skipped
    block would add p = 0 with a correction of 1.  While a profiler
    records, the pairs computed and skipped are counted
    (`attn.block_pairs`, `attn.block_pairs_skipped`).
    """
    if kernels:
        if scale is not None:
            raise ValueError("the flash kernel scales by 1 / sqrt(D): no "
                             f"scale {scale}")
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
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    qh = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)   # (B,Hkv,G,S,D)
    kh = k.transpose(1, 2).reshape(B * Hkv, T, D)
    vh = v.transpose(1, 2).reshape(B * Hkv, T, Dv)

    outs, pairs = [], 0
    for qi in range(nq):
        q_blk = qh[:, :, :, qi * bq:(qi + 1) * bq].reshape(B * Hkv, G * bq, D)
        qpos = (qi * bq + torch.arange(bq, device=dev)).repeat(G)
        m = torch.full((B * Hkv, G * bq), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((B * Hkv, G * bq), dtype=F32, device=dev)
        acc = torch.zeros((B * Hkv, G * bq, Dv), dtype=F32, device=dev)
        # causal: the kv blocks that hold a key <= the block's last row
        n_kv = min(nk, ((qi + 1) * bq + bk - 1) // bk) if causal else nk
        pairs += n_kv
        for kj in range(n_kv):
            blk = slice(kj * bk, (kj + 1) * bk)
            kpos = kj * bk + torch.arange(bk, device=dev)
            # scaled and masked in place: no product saves its output
            s = attention_dot(q_blk, kh[:, blk]).mul_(scale)
            if pad_k and kj == nk - 1:
                s.masked_fill_(kpos[None, :] >= T_orig, NEG_INF)
            if causal and (kj + 1) * bk - 1 > qi * bq:   # on the diagonal
                s.masked_fill_(qpos[:, None] < kpos[None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + attention_dot(p.to(v.dtype),
                                                        vh[:, blk].mT)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]   # (B Hkv, G bq, Dv)
        outs.append(out.reshape(B, Hkv, G, bq, Dv).permute(0, 3, 1, 2, 4)
                    .to(q.dtype))                          # (B,bq,Hkv,G,Dv)
    tr = device_tracer()
    tr.count("attn.block_pairs", pairs)
    tr.count("attn.block_pairs_skipped", nq * nk - pairs)
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


def decode_attention_kv_sharded(q, k_cache, v_cache, cur_len: int, mesh,
                                kv_axis=("data",)):
    """Long-context decode with the KV cache sharded along its sequence dim
    across `kv_axis` (flash-decoding style distributed split-KV): each shard
    computes partial (max, sum, acc) softmax statistics which are merged with
    cross-shard collectives. Exact (same result as decode_attention).

    q: (B, 1, Hq, D), the same on every rank; k_cache, v_cache: this rank's
    block (B, T/n, Hkv, D), positions [i T/n, (i+1) T/n) on the i-th rank
    along `kv_axis` (the reference's in_specs P(None, ax)).  The maxima
    merge by an all-reduce MAX, `l * corr` and `acc * corr` by SUMs; every
    rank returns the whole output.  A shard past `cur_len` is wholly masked
    and its weight `corr` is 0."""
    B, _, Hq, D = q.shape
    _, Tl, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    base = mesh.index(kv_axis) * Tl
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k_cache.float()) / math.sqrt(D)
    valid = base + torch.arange(Tl, device=q.device) < cur_len
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)                                         # (B,Hkv,G)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgt,bthd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    # merge partial softmax stats across KV shards
    m_all = all_reduce(m, mesh, kv_axis, torch.distributed.ReduceOp.MAX)
    corr = torch.exp(m - m_all)
    l_all = all_reduce(l * corr, mesh, kv_axis)
    acc_all = all_reduce(acc * corr[..., None], mesh, kv_axis)
    out = acc_all / torch.clamp_min(l_all, 1e-30)[..., None]
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


def glu_mlp(params, x, tp=None):
    """`tp`: a mesh whose "model" ranks split d_ff, `gate`/`up` this rank's
    columns and `down` its rows (column- then row-parallel): x enters
    through `copy_to` and the output sums over "model" (`reduce_from`)."""
    if tp is not None:
        x = copy_to(x, tp, "model")
    h = F.silu(x @ params["gate"]) * (x @ params["up"])
    y = h @ params["down"]
    return y if tp is None else reduce_from(y, tp, "model")


def gelu_mlp_specs(d_model: int, d_ff: int, dtype=torch.bfloat16):
    return {
        "in": ParamSpec((d_model, d_ff), dtype, ("embed", "mlp")),
        "in_b": ParamSpec((d_ff,), dtype, (None,), init="zeros"),
        "out": ParamSpec((d_ff, d_model), dtype, ("mlp", "embed")),
        "out_b": ParamSpec((d_model,), dtype, (None,), init="zeros"),
    }


def gelu_mlp(params, x, tp=None):
    """`tp`: as `glu_mlp`'s, `in` this rank's columns and `out` its rows;
    `in_b`, whole, is cut to this rank's d_ff slice, and `out_b` is added
    once, after the sum over "model"."""
    in_b = params["in_b"]
    if tp is not None:
        x = copy_to(x, tp, "model")
        in_b = rows(in_b, tp, "model")
    h = F.gelu(x @ params["in"] + in_b, approximate="tanh")
    y = h @ params["out"]
    if tp is not None:
        y = reduce_from(y, tp, "model")
    return y + params["out_b"]


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


def _rows_at(src, index, keep):
    """Rows of `src` (m, D) at `index`, zeros where `keep` is False."""
    return src.index_select(0, index).masked_fill_(~keep[:, None], 0)


class _Dispatch(torch.autograd.Function):
    """The capacity path's dispatch: token rows `xf` (n, D) into the E x C
    slots (E * C, D), slot s holding token `slot_row[s] // top_k` and
    zeros where `slot_row[s]` is n * top_k.  Backward: each (token, k)
    row's slot gradient (`slot_of_row`, zeros where not `ok`), summed over
    top_k in float32.  Both ways a gather: nothing accumulates."""

    @staticmethod
    def forward(ctx, xf, slot_row, slot_of_row, ok, top_k):
        ctx.save_for_backward(slot_of_row, ok)
        ctx.top_k = top_k
        # a row of zeros after the n tokens, which the empty slots' n * top_k
        # // top_k reads: cheaper than masking E x C rows after the gather
        pad = xf.new_zeros((1, xf.shape[1]))
        return torch.cat([xf, pad]).index_select(0, slot_row // top_k)

    @staticmethod
    def backward(ctx, g):
        slot_of_row, ok = ctx.saved_tensors
        rows = _rows_at(g, slot_of_row, ok)
        gx = torch.sum(rows.view(-1, ctx.top_k, g.shape[1]), dim=1,
                       dtype=F32)
        return gx.to(g.dtype), None, None, None, None


class _Combine(torch.autograd.Function):
    """The mirror of `_Dispatch`: the slots' rows `y_buf` (E * C, D) back
    to the (token, k) rows (n * top_k, D), row r the slot
    `slot_of_row[r]` and zeros where not `ok`.  Backward: each slot's
    row gradient at `slot_row`, zeros at an empty slot."""

    @staticmethod
    def forward(ctx, y_buf, slot_row, slot_of_row, ok):
        ctx.save_for_backward(slot_row)
        return _rows_at(y_buf, slot_of_row, ok)

    @staticmethod
    def backward(ctx, g):
        slot_row, = ctx.saved_tensors
        rows = g.shape[0]
        # masked, not padded: a padded copy of g would hold n * top_k more
        # rows at the backward's peak
        return _rows_at(g, torch.clamp_max(slot_row, rows - 1),
                        slot_row < rows), None, None, None


def tp_slice(params, mesh, tp_axis: str = "model"):
    """The MoE weights cut to this rank's d_ff slice over `tp_axis` (the
    reference's in_specs P(None, None, tp) for gate / up, P(None, tp, None)
    for down, and the shared experts' alike); the router stays whole.
    Cut blocks are contiguous copies, as the expert GEMM kernel needs."""
    if tp_axis not in mesh.axis_names or mesh.size(tp_axis) == 1:
        return params
    n, i = mesh.size(tp_axis), mesh.index(tp_axis)

    def cut(w, dim):
        f = w.shape[dim]
        if f % n:
            raise ValueError(f"d_ff {f} does not split over {n} "
                             f"{tp_axis!r} ranks")
        return w.narrow(dim, i * (f // n), f // n).contiguous()

    out = {"router": params["router"], "gate": cut(params["gate"], 2),
           "up": cut(params["up"], 2), "down": cut(params["down"], 1)}
    if "shared" in params:
        sp = params["shared"]
        out["shared"] = {"gate": cut(sp["gate"], 1), "up": cut(sp["up"], 1),
                         "down": cut(sp["down"], 0)}
    return out


def moe_ffn(params, x, *, top_k: int, mesh=None, dp_axes=("pod", "data"),
            tp_axis: str = "model", impl: str = "capacity",
            capacity_factor: float = 1.25, kernels: bool = False):
    """x: (B, S, D) -> (out, aux_loss). Token-local routing; expert weights
    sharded on d_ff across `tp_axis` (expert tensor parallelism -> one psum
    per MoE layer).

    Without a mesh, one device runs every token and every expert column.
    With one (`sharding.rules.Mesh`), the reference's region over whole
    arrays: every rank holds `x` and the weights whole; the tokens split
    over `dp_axes` present in the mesh (none when B does not divide), each
    rank takes its d_ff slice over `tp_axis` (`tp_slice`) and runs
    `moe_local`, and every rank returns the whole output.  The capacity
    C comes from each rank's own token count, so with more than one data
    rank other tokens drop than on one device, as in the reference.

    impl='capacity' (default): GShard-style fixed-capacity dispatch into
    E x C slots + batched expert GEMMs; tokens beyond an expert's capacity
    are dropped. A token's rank inside its expert comes from a stable
    argsort, as the reference's `jnp.argsort`, so the same tokens drop.
    `kernels=True` runs the three expert GEMMs through the CUDA kernel
    (`repro_torch.kernels.moe_gemm`).
    impl='ragged': sort + grouped GEMM (a loop over experts in place of
    `jax.lax.ragged_dot`) — exact (no drops). It has no kernel, so it
    raises with `kernels=True`.
    """
    kw = dict(top_k=top_k, impl=impl, capacity_factor=capacity_factor,
              kernels=kernels)
    if mesh is None:
        return moe_local(params, x, **kw)
    dp = batch_axes(mesh, x.shape[0], dp_axes)
    out, aux = moe_local(tp_slice(params, mesh, tp_axis), rows(x, mesh, dp),
                         mesh=mesh, dp=dp, tp_axis=tp_axis, **kw)
    return all_gather(out, mesh, dp, 0), aux


def route(probs, top_k: int, routing: dict | None = None):
    """(weights, experts) of each token's top_k, both (n, top_k), from the
    float32 router probabilities (n, E).  `routing` (a config's `moe`)
    may hold DeepSeek-V2's group-limited greedy choice: with `n_group`,
    a group of E / n_group experts scores its best probability, the
    `topk_group` best groups are kept and the top_k come from their
    experts alone.  The weights are renormalised to sum to 1 unless
    `norm_topk` is False, then multiplied by `routed_scaling` (1).

        >>> p = torch.tensor([[.30, .02, .25, .20, .01, .22]])
        >>> w, e = route(p, 2, {"n_group": 3, "topk_group": 1,
        ...                     "norm_topk": False, "routed_scaling": 2.0})
        >>> e.tolist(), [round(v, 2) for v in w[0].tolist()]
        ([[0, 1]], [0.6, 0.04])
    """
    routing = routing or {}
    n_group = routing.get("n_group")
    if n_group:
        n, E = probs.shape
        best = probs.view(n, n_group, E // n_group).amax(dim=-1)
        keep = torch.zeros_like(best, dtype=torch.bool).scatter_(
            1, torch.topk(best, routing["topk_group"], dim=-1).indices, True)
        probs = probs.masked_fill(
            ~keep.repeat_interleave(E // n_group, dim=1), 0.0)
    topv, topi = torch.topk(probs, top_k, dim=-1)              # (n, k)
    if routing.get("norm_topk", True):
        topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    scaling = routing.get("routed_scaling", 1.0)
    return (topv if scaling == 1.0 else topv * scaling), topi


def moe_local(params, x, *, top_k: int, mesh=None, dp=(),
              tp_axis: str = "model", impl: str = "capacity",
              capacity_factor: float = 1.25, kernels: bool = False,
              routing: dict | None = None):
    """`moe_ffn` on one rank's block (the reference's `local_fn`): `x` this
    rank's rows of a batch split over `dp`, the expert weights its d_ff
    slice over `tp_axis` (`tp_slice`).  The expert products' output sums
    over `tp_axis` in bf16 after rounding (`reduce_from`); the tokens and
    the routing weights enter the d_ff-split work through `copy_to`, so
    their gradients sum over `tp_axis`; `aux` is averaged over `dp`.
    Returns (this rank's rows of the output, aux).  `routing`: see
    `route` (every rank routes alike: the router and x are whole).

    The capacity path gives each kept (token, k) row, `t * top_k + j`, the
    slot `flat_e * C + rank`, which no other row has; a slot table
    (`slot_row`, E x C entries, n x top_k at an empty slot) comes from one
    scatter of the row ids, without accumulation.  The dispatch gathers
    the token rows into the slots (zeros at empty slots) and the combine
    gathers each kept row's slot back (zeros for a dropped row), each the
    other's backward (`_Dispatch`, `_Combine`); every filled slot holds
    exactly its row, as the reference's `.at[].add` onto zeros gives.
    While a profiler records, it counts its routed rows (`moe.rows_routed`,
    n x top_k), the rows past an expert's capacity (`moe.rows_dropped`)
    and its slots (`moe.slots`, E x C) on the device channel."""
    tp = tp_axis if mesh is not None and tp_axis in mesh.axis_names \
        else None
    B, S, D = x.shape
    E = params["router"].shape[1]
    wg, wu, wd = params["gate"], params["up"], params["down"]
    n = B * S
    xf = x.reshape(n, D)
    logits = xf.float() @ params["router"]                     # (n, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = route(probs, top_k, routing)                  # (n, k)
    flat_e = topi.reshape(-1)                                  # (n*k,) token-major
    # per-expert slot counts by a static-shape scatter-add, as the
    # reference's `zeros((E,)).at[flat_e].add(1)` (`bincount`'s output
    # shape depends on the data, which a shape-only run cannot give)
    group_sizes = torch.zeros(E, dtype=torch.int64,
                              device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    w_slot = topv.reshape(-1).float()
    if tp is not None:          # into the work split over d_ff
        xf, w_slot = copy_to(xf, mesh, tp), copy_to(w_slot, mesh, tp)

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
        tr = device_tracer()
        tr.count("moe.rows_routed", n * top_k)
        tr.count("moe.rows_dropped", lambda: (~ok).sum())
        tr.count("moe.slots", E * C)
        # a kept row's slot is its own; the dropped rows all write the
        # table's extra last entry, which is cut off
        slot_of_row = flat_e * C + torch.clamp_max(rank, C - 1)
        slot_row = torch.full((E * C + 1,), n * top_k, dtype=idx.dtype,
                              device=x.device).scatter_(
            0, torch.where(ok, slot_of_row, E * C), idx)[:E * C]
        buf = _Dispatch.apply(xf, slot_row, slot_of_row, ok,
                              top_k).view(E, C, D)
        h = F.silu(gemm(buf, wg)) * gemm(buf, wu)              # (E, C, F)
        y_buf = gemm(h, wd)
        y = _Combine.apply(y_buf.reshape(E * C, D), slot_row, slot_of_row,
                           ok)
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
        w_sorted = w_slot[order]
        out = torch.zeros((n, D), dtype=F32, device=x.device).index_add_(
            0, tok, y.float() * w_sorted[:, None])
    else:
        raise ValueError(f"unknown MoE impl {impl!r}")

    if "shared" in params:
        sp = params["shared"]
        hs = F.silu(xf @ sp["gate"]) * (xf @ sp["up"])
        out = out + (hs @ sp["down"]).float()
    out = out.to(x.dtype)
    if tp is not None:
        # reduce activations in bf16 (dots already accumulated fp32
        # locally); halves expert-TP wire bytes
        out = reduce_from(out, mesh, tp)
    # switch-style load-balance aux loss
    frac = group_sizes.float() / max(n * top_k, 1)
    imp = probs.mean(dim=0)
    aux = E * torch.sum(frac * imp)
    if dp:
        aux = mean_over(aux, mesh, dp)
    return out.reshape(B, S, D), aux
