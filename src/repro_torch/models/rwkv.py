"""RWKV-6 "Finch" layer (arXiv:2404.05892): linear attention with
data-dependent per-channel decay, chunked parallel form for prefill and
recurrent form for decode, from the JAX package's `repro/models/rwkv.py`.

Per head (key dim K, value dim V):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t                S: (K, V)
    o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t          u: per-channel bonus

The chunked form evaluates the intra-chunk causal part with an explicit
(L, L, K) decay tensor (numerically safe: all exponents are <= 0, no
factored exp blow-up), and carries S across chunks with a loop (the
reference's `lax.scan`).  `rwkv6_time_mix(..., kernels=True)` runs the
prefill scan through the CUDA kernel (`repro_torch.kernels.rwkv6_scan`) and
`ln_out` through the rmsnorm kernel; decode stays plain torch.

`tp` (a mesh) runs either block tensor-parallel over its "model" ranks.
The time mix on this rank's heads: x enters through `copy_to` before the
token shift, `Wr`, `Wk`, `Wv`, `Wg` and `w_lora_b` hold the heads'
columns and `Wo` their rows, `u`, `w_bias` and `ln_out` are sliced to
them, `ln_out` runs over the split row (`layers.rmsnorm_split`, plain
math) and the output sums over "model".  The channel mix on this rank's d_ff: `copy_to`
on the k path alone (`x @ Wr`, whole, is the same work on every rank),
`Wk`'s columns and `Wv`'s rows, one `reduce_from` before the gate.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import LOGW_MIN, rwkv6_scan
from repro_torch.models.layers import rmsnorm, rmsnorm_split
from repro_torch.models.module import ParamSpec
from repro_torch.sharding.collectives import copy_to, reduce_from, rows

F32 = torch.float32


def rwkv6_chunked(r, k, v, logw, u, chunk: int = 32, initial_state=None):
    """r,k,logw: (B,S,H,K); v: (B,S,H,V); u: (H,K).

    Returns (o: (B,S,H,V), final_state: (B,H,K,V))."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    L = min(chunk, S)
    nc = S // L
    assert nc * L == S

    logw = torch.clamp(logw.float(), LOGW_MIN, 0.0)
    rc = r.reshape(B, nc, L, H, K).float()
    kc = k.reshape(B, nc, L, H, K).float()
    vc = v.reshape(B, nc, L, H, V).float()
    wc = logw.reshape(B, nc, L, H, K)

    cum = torch.cumsum(wc, dim=2)                      # inclusive (B,nc,L,H,K)
    cum_ex = cum - wc                                  # exclusive:  sum_{j<i}

    # ---- intra-chunk: A[l,s] = sum_k r_l k_s exp(cum_ex_l - cum_s), s < l ---
    diff = cum_ex[:, :, :, None] - cum[:, :, None, :, :, :]   # (B,nc,L,L,H,K)
    tri = torch.ones(L, L, dtype=torch.bool, device=r.device).tril(-1)
    dec = torch.where(tri[None, None, :, :, None, None], diff, -torch.inf)
    A = torch.einsum("bclhk,bclshk->bclsh",
                     rc, torch.exp(dec) * kc[:, :, None])      # (B,nc,L,L,H)
    o_intra = torch.einsum("bclsh,bcshv->bclhv", A, vc)
    # current-token bonus
    bonus = torch.einsum("bclhk,bclhk->bclh", rc, u[None, None, None] * kc)
    o_intra = o_intra + bonus[..., None] * vc

    # ---- inter-chunk state carry --------------------------------------------
    # state contribution of chunk c: sum_j diag(exp(cum_L - cum_j)) k_j^T v_j
    k_dec = kc * torch.exp(cum[:, :, -1:, :, :] - cum)         # (B,nc,L,H,K)
    chunk_kv = torch.einsum("bclhk,bclhv->bchkv", k_dec, vc)
    chunk_decay = torch.exp(cum[:, :, -1])                      # (B,nc,H,K)

    s = (r.new_zeros((B, H, K, V), dtype=F32) if initial_state is None
         else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(s)                                          # state BEFORE chunk
        s = s * chunk_decay[:, c, :, :, None] + chunk_kv[:, c]
    prev = torch.stack(prev, dim=1)                             # (B,nc,H,K,V)

    r_dec = rc * torch.exp(cum_ex)                              # (B,nc,L,H,K)
    o_inter = torch.einsum("bclhk,bchkv->bclhv", r_dec, prev)

    o = (o_intra + o_inter).reshape(B, S, H, V)
    return o.to(r.dtype), s


def rwkv6_scan_oracle(r, k, v, logw, u, initial_state=None):
    """Pure per-token recurrence (test oracle)."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    logw = torch.clamp(logw.float(), LOGW_MIN, 0.0)
    s = (r.new_zeros((B, H, K, V), dtype=F32) if initial_state is None
         else initial_state.float())
    rf, kf, vf = r.float(), k.float(), v.float()
    os = []
    for t in range(S):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], logw[:, t]
        os.append(torch.einsum("bhk,bhkv->bhv", rt, s) +
                  torch.einsum("bhk,bhk->bh", rt, u[None] * kt)[..., None]
                  * vt)
        s = s * torch.exp(wt)[..., None] + torch.einsum("bhk,bhv->bhkv",
                                                        kt, vt)
    return torch.stack(os, dim=1).to(r.dtype), s


def rwkv6_decode_step(state, r, k, v, logw, u):
    """One token: r,k,v,logw (B,1,H,*). Returns (o, new_state)."""
    rt, kt, vt = r[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    wt = torch.clamp(logw[:, 0].float(), LOGW_MIN, 0.0)
    o = torch.einsum("bhk,bhkv->bhv", rt, state) + \
        torch.einsum("bhk,bhk->bh", rt, u[None] * kt)[..., None] * vt
    s = state * torch.exp(wt)[..., None] + torch.einsum("bhk,bhv->bhkv",
                                                        kt, vt)
    return o[:, None].to(r.dtype), s


# ---------------------------------------------------------------------------
# RWKV-6 block: time-mix (wkv attention) + channel-mix, with token-shift
# ---------------------------------------------------------------------------

def rwkv6_specs(d_model: int, head_dim: int = 64, d_ff: int | None = None,
                dtype=torch.bfloat16):
    H = d_model // head_dim
    d_ff = d_ff or int(3.5 * d_model)
    lora = max(32, d_model // 16)
    return {
        "tm": {  # time mix
            "mu_r": ParamSpec((d_model,), dtype, (None,), init="zeros"),
            "mu_k": ParamSpec((d_model,), dtype, (None,), init="zeros"),
            "mu_v": ParamSpec((d_model,), dtype, (None,), init="zeros"),
            "mu_w": ParamSpec((d_model,), dtype, (None,), init="zeros"),
            "mu_g": ParamSpec((d_model,), dtype, (None,), init="zeros"),
            "Wr": ParamSpec((d_model, d_model), dtype, ("embed", "heads")),
            "Wk": ParamSpec((d_model, d_model), dtype, ("embed", "heads")),
            "Wv": ParamSpec((d_model, d_model), dtype, ("embed", "heads")),
            "Wg": ParamSpec((d_model, d_model), dtype, ("embed", "heads")),
            "Wo": ParamSpec((d_model, d_model), dtype, ("heads", "embed")),
            # data-dependent decay: w = exp(-softplus(lora path)) per channel
            "w_lora_a": ParamSpec((d_model, lora), dtype, ("embed", None)),
            "w_lora_b": ParamSpec((lora, d_model), dtype, (None, "heads")),
            "w_bias": ParamSpec((d_model,), torch.float32, (None,), init="zeros"),
            "u": ParamSpec((H, head_dim), torch.float32, (None, None),
                           init="zeros"),
            "ln_out": ParamSpec((d_model,), dtype, (None,), init="ones"),
        },
        "cm": {  # channel mix
            "mu_k": ParamSpec((d_model,), dtype, (None,), init="zeros"),
            "Wk": ParamSpec((d_model, d_ff), dtype, ("embed", "mlp")),
            "Wv": ParamSpec((d_ff, d_model), dtype, ("mlp", "embed")),
            "Wr": ParamSpec((d_model, d_model), dtype, ("embed", None)),
        },
    }


def _token_shift(x, last):
    """shift(x)[t] = x[t-1]; position 0 takes `last` (decode carry)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def rwkv6_time_mix(p, x, *, head_dim: int = 64, chunk: int = 32,
                   state=None, last_x=None, tp=None, kernels: bool = False):
    """Returns (y, (state, last x)); state/last_x given => carried in.
    `tp`: this rank's heads of its "model" ranks (module docstring); the
    state then holds those heads."""
    B, S, D = x.shape
    H = p["Wr"].shape[1] // head_dim
    u, w_bias, ln_out = p["u"], p["w_bias"], p["ln_out"]
    if tp is not None:
        x = copy_to(x, tp, "model")
        u, w_bias, ln_out = (rows(v, tp, "model") for v in (u, w_bias,
                                                            ln_out))
    last = last_x if last_x is not None else x.new_zeros((B, D))
    xs = _token_shift(x, last)

    def mix(mu):
        return x + (xs - x) * mu

    r = (mix(p["mu_r"]) @ p["Wr"]).reshape(B, S, H, head_dim)
    k = (mix(p["mu_k"]) @ p["Wk"]).reshape(B, S, H, head_dim)
    v = (mix(p["mu_v"]) @ p["Wv"]).reshape(B, S, H, head_dim)
    g = F.silu(mix(p["mu_g"]) @ p["Wg"])
    w_raw = (mix(p["mu_w"]).float() @ p["w_lora_a"].float()
             @ p["w_lora_b"].float()) + w_bias
    logw = -F.softplus(-w_raw) - 0.5                      # in (-inf, -0.5)
    logw = logw.reshape(B, S, H, head_dim)

    if S > 1:  # prefill (chunked parallel form)
        if kernels:
            o, s_final = rwkv6_scan(r, k, v, logw, u, chunk=chunk,
                                    initial_state=state)
        else:
            o, s_final = rwkv6_chunked(r, k, v, logw, u, chunk=chunk,
                                       initial_state=state)
    else:      # decode (recurrent form)
        s0 = state if state is not None else x.new_zeros(
            (B, H, head_dim, head_dim), dtype=F32)
        o, s_final = rwkv6_decode_step(s0, r, k, v, logw, u)

    o = o.reshape(B, S, H * head_dim)
    if tp is None:
        o = rmsnorm(o, ln_out, kernels=kernels) * g
        return o @ p["Wo"], (s_final, x[:, -1, :])
    o = rmsnorm_split(o, ln_out, tp) * g
    return reduce_from(o @ p["Wo"], tp, "model"), (s_final, x[:, -1, :])


def rwkv6_channel_mix(p, x, last_x=None, tp=None):
    """Returns (y, last x); `tp`: `Wk`'s columns and `Wv`'s rows are this
    rank's d_ff of its "model" ranks (module docstring)."""
    B, S, D = x.shape
    last = last_x if last_x is not None else x.new_zeros((B, D))
    xk_in = x if tp is None else copy_to(x, tp, "model")
    xs = _token_shift(xk_in, last)
    xk = xk_in + (xs - xk_in) * p["mu_k"]
    k = torch.square(torch.relu(xk @ p["Wk"]))
    r = torch.sigmoid(x @ p["Wr"])
    kv = k @ p["Wv"]
    return r * (kv if tp is None else reduce_from(kv, tp, "model")), \
        x[:, -1, :]
