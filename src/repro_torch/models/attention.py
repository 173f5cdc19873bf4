"""Attention blocks: GQA/MQA (llama-family, with RoPE or Qwen2-VL's M-RoPE,
and the encoder-decoder's cross attention) and MLA (DeepSeek-V2,
arXiv:2405.04434), with prefill (blocked attention) and decode (KV cache)
paths, from the JAX package's `repro/models/attention.py`. MLA caches only
the compressed latent (kv_lora) + shared rope key and uses the
absorbed-matmul decode path (the W_UK / W_UV absorption trick).

Caches are written in place where the reference returns a donated copy
(`dynamic_update_slice`), and the same dict is returned.

`kv_seq_shard` with a mesh keeps GQA's cache in the split-KV layout: every
row of the batch, the sequence split over `kv_axis` ("data"), one block a
rank.  The rest of the step splits the batch over the data-parallel axes,
so the decode step gathers q, k and v across them on the way in, writes
the new position on the rank that holds it, runs
`layers.decode_attention_kv_sharded`, and keeps this rank's rows of the
output; prefill writes the prompt's positions into each rank's block.

`tp` (a mesh) runs GQA tensor-parallel over its "model" ranks, on whole
heads (`heads_split`): `wq`'s columns and `wo`'s rows are this rank's
heads, `wk` and `wv` are whole and the rank takes the columns of its
contiguous range of KV heads (`kv_range`), x enters through `copy_to` and
the output sums over "model" (`reduce_from`).  The caches keep every KV
head (`zoo.cache_shardings`); a rank fills and reads only its range, a
view, so the attention kernels take it as they take the whole cache.

`mla_attention(tp=)` runs MLA on this rank's heads the same way: `wq`
(or with low-rank queries `wq_b`), `wk_b` and `wv_b` hold their columns
and `wo` their rows, while `wkv_a` and `kv_norm` (and `wq_a`, `q_norm`)
are whole, so every rank computes the same latent and rope key and fills
the same latent cache; the absorbed decode runs on the local heads.

`kernels=True` runs GQA's attention through the flash and decode attention
kernels, MLA's `kv_norm` and `q_norm` through the rmsnorm kernel, and MLA's
prefill attention (q and k of qk_nope + qk_rope columns, v of v_dim)
through `kernels.mla_attention`, which reads the shared rope key once a
tile in place of building per-head keys, where its `variant` takes the
call ("mma": bfloat16 on the card at the widths it is compiled for); every
other MLA prefill, the CPU's among them, runs the plain blocked attention
on per-head keys.  MLA's absorbed decode stays plain PyTorch on every
device, as it reaches no Pallas kernel in the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import mla_attention as mla_kernel
from repro_torch.models.layers import (NEG_INF, apply_mrope, apply_rope,
                                       blocked_attention, decode_attention,
                                       decode_attention_kv_sharded, rmsnorm,
                                       yarn_mscale)
from repro_torch.models.module import ParamSpec
from repro_torch.sharding.collectives import copy_to, reduce_from, rows
from repro_torch.sharding.rules import all_gather, batch_axes

KV_AXIS = ("data",)     # the split-KV axis (`decode_attention_kv_sharded`)


# ---------------------------------------------------------------------------
# GQA / MQA
# ---------------------------------------------------------------------------

def gqa_specs(d_model: int, n_heads: int, n_kv: int, head_dim: int,
              dtype=torch.bfloat16):
    return {
        "wq": ParamSpec((d_model, n_heads * head_dim), dtype, ("embed", "heads")),
        "wk": ParamSpec((d_model, n_kv * head_dim), dtype, ("embed", "kv_heads")),
        "wv": ParamSpec((d_model, n_kv * head_dim), dtype, ("embed", "kv_heads")),
        "wo": ParamSpec((n_heads * head_dim, d_model), dtype, ("heads", "embed")),
    }


def heads_split(n_heads: int, n_kv: int, mesh) -> bool:
    """Whether GQA's heads split over `mesh`'s "model" ranks on whole
    heads: the local count L = n_heads / model is whole, and L % G == 0 or
    G % L == 0 (G = n_heads / n_kv), so that each rank's query heads use a
    contiguous range of whole KV heads.

        >>> from repro_torch.sharding.rules import Mesh
        >>> [heads_split(h, kv, Mesh.abstract((1, 16), ("data", "model")))
        ...  for h, kv in ((64, 8), (48, 1), (24, 8), (20, 20))]
        [True, True, False, False]
    """
    m = mesh.size("model")
    if m == 1 or n_heads % m:
        return False
    L, G = n_heads // m, n_heads // n_kv
    return L % G == 0 or G % L == 0


def kv_range(n_heads: int, n_kv: int, tp) -> tuple[int, int]:
    """(first KV head, KV head count) of this rank's query heads under
    `heads_split` ((0, n_kv) without `tp`).

        >>> from repro_torch.sharding.rules import Mesh
        >>> kv_range(48, 1, Mesh.abstract((1, 16), ("data", "model")))
        (0, 1)
    """
    if tp is None:
        return 0, n_kv
    L, G = n_heads // tp.size("model"), n_heads // n_kv
    return tp.index("model") * L // G, max(L // G, 1)


def kv_cols(w, lo: int, n: int, head_dim: int):
    """The columns of KV heads [lo, lo + n) of a (D, n_kv * head_dim)
    projection, a view."""
    return w[:, lo * head_dim:(lo + n) * head_dim]


def gqa_attention(params, x, positions, *, n_heads, n_kv, head_dim,
                  rope="rope", rope_theta=1e4, mrope_sections=None,
                  mrope_positions=None, causal=True, cache=None,
                  cur_len=None, mesh=None, kv_seq_shard=False, block_q=512,
                  block_kv=1024, cross_kv=None, tp=None,
                  kernels: bool = False):
    """x: (B,S,D). cache: dict(k,v: (B,T,Hkv,Dh)) for decode and prefill,
    written in place; cur_len: Python int (decode).  `kv_seq_shard` with a
    `mesh`: the cache is in the split-KV layout (module docstring) and x
    holds this rank's rows.  `tp`: the heads split over its "model" ranks
    (module docstring).

    Returns (out, cache). cross_kv: (k, v) for encoder-decoder cross-attn
    (no rope, no cache update, non-causal over encoder length), with `tp`
    this rank's KV heads (`kv_range`); it returns None for the cache."""
    B, S, D = x.shape
    Hq = n_heads
    lo, Hkv = kv_range(n_heads, n_kv, tp)
    wk, wv = params["wk"], params["wv"]
    if tp is not None:
        x = copy_to(x, tp, "model")
        Hq = n_heads // tp.size("model")
        wk, wv = (kv_cols(w, lo, Hkv, head_dim) for w in (wk, wv))
    q = (x @ params["wq"]).reshape(B, S, Hq, head_dim)

    def out_proj(out):
        y = out.reshape(B, S, -1) @ params["wo"]
        return y if tp is None else reduce_from(y, tp, "model")

    if cross_kv is not None:
        k, v = cross_kv
        out = blocked_attention(q, k, v, causal=False, block_q=block_q,
                                block_kv=block_kv, kernels=kernels)
        return out_proj(out), None

    k = (x @ wk).reshape(B, S, Hkv, head_dim)
    v = (x @ wv).reshape(B, S, Hkv, head_dim)
    if rope == "rope":
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    elif rope == "mrope":
        q = apply_mrope(q, mrope_positions, mrope_sections, rope_theta)
        k = apply_mrope(k, mrope_positions, mrope_sections, rope_theta)

    # this rank's KV heads of the cache (all of them without `tp`): views
    kv = None if cache is None else {
        n: cache[n] if tp is None else cache[n][:, :, lo:lo + Hkv]
        for n in ("k", "v")}
    if cache is not None and kv_seq_shard and mesh is not None:
        out = _kv_sharded(q, k, v, kv, cur_len, mesh, causal=causal,
                          block_q=block_q, block_kv=block_kv,
                          kernels=kernels)
    elif cache is None:
        out = blocked_attention(q, k, v, causal=causal, block_q=block_q,
                                block_kv=block_kv, kernels=kernels)
    elif S == 1:  # decode step
        kv["k"][:, cur_len:cur_len + 1] = k
        kv["v"][:, cur_len:cur_len + 1] = v
        out = decode_attention(q, kv["k"], kv["v"], cur_len + 1,
                               kernels=kernels)
    else:  # prefill: compute attention and fill the cache
        out = blocked_attention(q, k, v, causal=causal, block_q=block_q,
                                block_kv=block_kv, kernels=kernels)
        kv["k"][:, :S] = k
        kv["v"][:, :S] = v

    return out_proj(out), cache


def _kv_sharded(q, k, v, cache, cur_len, mesh, *, causal, block_q,
                block_kv, kernels):
    """Attention over the split-KV cache layout: q, k, v hold this rank's
    rows of a batch split over the data-parallel axes; the cache holds
    every row and this rank's block of positions along `KV_AXIS`."""
    B_all, Tl = cache["k"].shape[:2]
    dp = batch_axes(mesh, B_all)
    lo = mesh.index(KV_AXIS) * Tl
    S = q.shape[1]
    start = 0 if S > 1 else cur_len
    kf, vf = all_gather(k, mesh, dp, 0), all_gather(v, mesh, dp, 0)
    a, b = max(start, lo), min(start + S, lo + Tl)
    if a < b:               # the new positions this rank's block holds
        cache["k"][:, a - lo:b - lo] = kf[:, a - start:b - start]
        cache["v"][:, a - lo:b - lo] = vf[:, a - start:b - start]
    if S > 1:               # prefill: attention over the prompt itself
        return blocked_attention(q, k, v, causal=causal, block_q=block_q,
                                 block_kv=block_kv, kernels=kernels)
    out = decode_attention_kv_sharded(all_gather(q, mesh, dp, 0), cache["k"],
                                      cache["v"], cur_len + 1, mesh, KV_AXIS)
    return rows(out, mesh, dp)


def gqa_cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", "kv_seq", "kv_heads", None)
    return {"k": ParamSpec(shape, dtype, axes, init="zeros"),
            "v": ParamSpec(shape, dtype, axes, init="zeros")}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_specs(d_model: int, n_heads: int, qk_nope: int, qk_rope: int,
              v_dim: int, kv_lora: int, dtype=torch.bfloat16,
              q_lora: int | None = None):
    """MLA's parameters; `q_lora` projects the queries through a latent of
    that width (`wq_a`, RMSNorm `q_norm`, `wq_b`) in place of `wq`."""
    q_out = n_heads * (qk_nope + qk_rope)
    if q_lora:
        q = {"wq_a": ParamSpec((d_model, q_lora), dtype, ("embed", None)),
             "q_norm": ParamSpec((q_lora,), dtype, (None,), init="ones"),
             "wq_b": ParamSpec((q_lora, q_out), dtype, (None, "heads"))}
    else:
        q = {"wq": ParamSpec((d_model, q_out), dtype, ("embed", "heads"))}
    return {
        **q,
        "wkv_a": ParamSpec((d_model, kv_lora + qk_rope), dtype, ("embed", None)),
        "kv_norm": ParamSpec((kv_lora,), dtype, (None,), init="ones"),
        "wk_b": ParamSpec((kv_lora, n_heads * qk_nope), dtype, (None, "heads")),
        "wv_b": ParamSpec((kv_lora, n_heads * v_dim), dtype, (None, "heads")),
        "wo": ParamSpec((n_heads * v_dim, d_model), dtype, ("heads", "embed")),
    }


def mla_temperature(rope_scaling: dict | None) -> float:
    """The factor YaRN puts on MLA's scores beside (qk_nope + qk_rope) **
    -1/2: m(factor, mscale_all_dim) squared, 1 without `rope_scaling` or
    its `mscale_all_dim`.

        >>> round(mla_temperature({"type": "yarn", "factor": 40,
        ...                        "mscale_all_dim": 0.707}), 4)
        1.5896
    """
    if not rope_scaling or not rope_scaling.get("mscale_all_dim"):
        return 1.0
    return yarn_mscale(rope_scaling["factor"],
                       rope_scaling["mscale_all_dim"]) ** 2


def mla_attention(params, x, positions, *, n_heads, qk_nope, qk_rope, v_dim,
                  kv_lora, rope_theta=1e4, rope_scaling=None, cache=None,
                  cur_len=None, block_q=512, block_kv=1024, tp=None,
                  kernels: bool = False):
    """Returns (out, cache); cache = dict(ckv: (B,T,kv_lora),
    kr: (B,T,qk_rope)), written in place; cur_len: Python int (decode).
    `tp`: the heads split over its "model" ranks (module docstring).
    Low-rank queries (`wq_a`, `q_norm`, `wq_b` in `params`, `mla_specs`'
    `q_lora`): q = RMSNorm(x wq_a) wq_b.  `rope_scaling` (YaRN) turns the
    rope parts of q and k by `layers.apply_rope`'s YaRN frequencies and
    scales the scores by `mla_temperature`, in prefill and in the
    absorbed decode alike.

    `kernels` runs `kv_norm` and `q_norm` through the rmsnorm kernel and
    the prefill attention through `kernels.mla_attention` where that
    kernel takes it (see the module's docstring)."""
    B, S, D = x.shape
    if tp is not None:
        x = copy_to(x, tp, "model")
        n_heads //= tp.size("model")
    temp = mla_temperature(rope_scaling)
    if "wq_a" in params:
        q = rmsnorm(x @ params["wq_a"], params["q_norm"],
                    kernels=kernels) @ params["wq_b"]
    else:
        q = x @ params["wq"]
    q = q.reshape(B, S, n_heads, qk_nope + qk_rope)
    qn, qr = q[..., :qk_nope], q[..., qk_nope:]
    qr = apply_rope(qr, positions, rope_theta, rope_scaling)

    kv = x @ params["wkv_a"]
    latent = kv[..., :kv_lora]          # a view with rows kv_lora + qk_rope
    if kernels:                         # apart; the kernel takes rows
        latent = latent.contiguous()    # laid end to end
    ckv = rmsnorm(latent, params["kv_norm"], kernels=kernels)   # (B,S,ckv)
    kr = apply_rope(kv[..., kv_lora:][:, :, None, :], positions,
                    rope_theta, rope_scaling)[:, :, 0, :]       # (B,S,dr)

    if cache is not None and S == 1:  # absorbed decode path
        cache["ckv"][:, cur_len:cur_len + 1] = ckv
        cache["kr"][:, cur_len:cur_len + 1] = kr
        ckv_c, kr_c = cache["ckv"].float(), cache["kr"].float()
        wk_b = params["wk_b"].reshape(kv_lora, n_heads, qk_nope).float()
        wv_b = params["wv_b"].reshape(kv_lora, n_heads, v_dim).float()
        # absorb W_UK into the query: scores via the latent space
        q_c = torch.einsum("bhd,khd->bhk", qn[:, 0].float(), wk_b)  # (B,H,ckv)
        s = (torch.einsum("bhk,btk->bht", q_c, ckv_c)
             + torch.einsum("bhr,btr->bht", qr[:, 0].float(), kr_c)
             ) / math.sqrt(qk_nope + qk_rope)
        if temp != 1.0:
            s = s * temp
        T = ckv_c.shape[1]
        valid = torch.arange(T, device=x.device) <= cur_len
        s = torch.where(valid[None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bht,btk->bhk", p, ckv_c)             # (B,H,ckv)
        heads = torch.einsum("bhk,khd->bhd", ctx, wv_b)
        out = heads.reshape(B, 1, n_heads * v_dim).to(x.dtype)
        return _mla_out(out, params["wo"], tp), cache

    # prefill: decompress per-head keys/values; the kernel takes the rope
    # key once for all heads, the plain path per-head keys
    kn = (ckv @ params["wk_b"]).reshape(B, S, n_heads, qk_nope)
    vv = (ckv @ params["wv_b"]).reshape(B, S, n_heads, v_dim)
    scale = temp / math.sqrt(qk_nope + qk_rope)
    if kernels and q.is_cuda and \
            mla_kernel.variant(q, kn, kr, vv) == "mma":
        q[..., qk_nope:] = qr           # q's rows hold qn and the turned qr
        out = mla_kernel.mla_attention_fwd(q, kn, kr, vv, scale=scale)
    else:
        kr_b = kr[:, :, None, :].expand(B, S, n_heads, qk_rope)
        qf = torch.cat([qn, qr], dim=-1)
        kf = torch.cat([kn, kr_b], dim=-1)
        out = blocked_attention(qf, kf, vv, causal=True, block_q=block_q,
                                block_kv=block_kv, scale=scale)
    if cache is not None:  # prefill fills the latent cache
        cache["ckv"][:, :S] = ckv
        cache["kr"][:, :S] = kr
    return _mla_out(out.reshape(B, S, -1), params["wo"], tp), cache


def _mla_out(heads, wo, tp):
    y = heads @ wo
    return y if tp is None else reduce_from(y, tp, "model")


def mla_cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    m = cfg.mla
    return {
        "ckv": ParamSpec((batch, max_len, m["kv_lora"]), dtype,
                         ("batch", "kv_seq", None), init="zeros"),
        "kr": ParamSpec((batch, max_len, m["qk_rope"]), dtype,
                        ("batch", "kv_seq", None), init="zeros"),
    }
