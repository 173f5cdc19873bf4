"""Plain float32 reference of the RWKV-6 "Finch" decoder (arXiv:2404.05892)
as the configuration file states it.

Each layer: x += TimeMix(RMSNorm(x)); x += ChannelMix(RMSNorm(x)).

Time mix on h (B, T, D), with h[-1] = 0 before the first position:
    m_c = h + (h[t-1] - h) * mu_c                for c in r, k, v, g, w
    r, k, v = m_r Wr, m_k Wk, m_v Wv             (heads of K = V = 64)
    g = silu(m_g Wg)
    logw = clip(-softplus(-(m_w A B + w_bias)) - 0.5, -6, 0)
    per head: S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t       (K, V)
              o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
    y = (RMSNorm(o) * g) Wo
Channel mix on h, with its own shift:
    y = sigmoid(h Wr) * (relu(m_k Wk)^2 Wv),  m_k = h + (h[t-1] - h) * mu_k
The state and the shifts start at zero for every served prompt.

The recurrence is evaluated in chunks of `CHUNK` positions: inside a chunk
by the decays between positions (every exponent <= 0), many chunks at
once, across chunks by carrying S in order.  `param_layout` is the tree
the benchmark makes from the seed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference import common
from reference.common import Precision

LOGW_MIN = -6.0
CHUNK = 32


def _leaf(shape, dtype="bfloat16", init="normal", scale=None):
    if scale is None and init == "normal":
        scale = float(shape[-2]) ** -0.5
    return {"shape": list(shape), "dtype": dtype, "init": init,
            "scale": scale}


def param_layout(cfg: dict) -> dict:
    D, hd, V, Fd, L = cfg["d_model"], cfg["head_dim"], cfg["vocab"], \
        cfg["d_ff"], cfg["n_layers"]
    H = D // hd
    lora = max(32, D // 16)

    def st(shape, **kw):
        leaf = _leaf(shape, **kw)
        return dict(leaf, shape=[L] + leaf["shape"], stacked=True)

    mix = {f"mu_{c}": st((D,), init="uniform") for c in "rkvwg"}
    tm = dict(mix, **{n: st((D, D)) for n in ("Wr", "Wk", "Wv", "Wg")})
    tm.update(Wo=st((D, D)), w_lora_a=st((D, lora)),
              w_lora_b=st((lora, D)),
              w_bias=st((D,), dtype="float32", init="normal", scale=1.0),
              u=st((H, hd), dtype="float32", init="normal", scale=0.5),
              ln_out=st((D,), init="ones"))
    return {"embed": _leaf((V, D), scale=0.02),
            "final_norm": {"scale": _leaf((D,), init="ones")},
            "lm_head": _leaf((V, D), scale=0.02),
            "layers": {"ln1": {"scale": st((D,), init="ones")},
                       "mixer": {"tm": tm},
                       "ln2": {"scale": st((D,), init="ones")},
                       "ffn": {"mu_k": st((D,), init="uniform"),
                               "Wk": st((D, Fd)), "Wv": st((Fd, D)),
                               "Wr": st((D, D))}}}


def wkv(r, k, v, logw, u, chunk: int = CHUNK):
    """The recurrence over (B, T, H, K) inputs from a zero state, float32;
    returns o (B, T, H, V).  Positions past T pad the last chunk (their k
    and v are zero, so they add nothing to the state)."""
    B, T, H, K = r.shape
    Vd = v.shape[-1]
    L = chunk
    pad = (-T) % L
    if pad:
        r, k, v, logw = (torch.cat([x, x.new_zeros((B, pad) + x.shape[2:])],
                                   dim=1) for x in (r, k, v, logw))
    nc = (T + pad) // L
    rc, kc, wc = (x.reshape(B, nc, L, H, K) for x in (r, k, logw))
    vc = v.reshape(B, nc, L, H, Vd)
    cum = torch.cumsum(wc, dim=2)                     # through t
    before = cum - wc                                 # through t - 1
    lower = torch.ones(L, L, dtype=torch.bool, device=r.device).tril(-1)
    # inside a chunk: j < t decays from after j to before t (exponent <= 0)
    group = max(1, 2 ** 27 // (B * L * L * H * K))
    intra = []
    for lo in range(0, nc, group):
        sl = slice(lo, lo + group)
        diff = before[:, sl, :, None] - cum[:, sl, None]   # (B,G,t,j,H,K)
        dec = torch.where(lower[:, :, None, None], diff,
                          torch.full_like(diff, float("-inf")))
        att = torch.einsum("bgthk,bgtjhk,bgjhk->bgtjh", rc[:, sl],
                           torch.exp(dec), kc[:, sl])
        intra.append(torch.einsum("bgtjh,bgjhv->bgthv", att, vc[:, sl]))
    o = torch.cat(intra, dim=1)
    o = o + torch.einsum("bcthk,bcthk->bcth", rc, u * kc)[..., None] * vc
    # across chunks: the state before each chunk, carried in order
    last = cum[:, :, -1:]                             # (B, nc, 1, H, K)
    kv = torch.einsum("bcjhk,bcjhv->bchkv", kc * torch.exp(last - cum), vc)
    decay = torch.exp(last[:, :, 0])[..., None]       # (B, nc, H, K, 1)
    s = r.new_zeros((B, H, K, Vd))
    states = []
    for c in range(nc):
        states.append(s)
        s = s * decay[:, c] + kv[:, c]
    o = o + torch.einsum("bcthk,bchkv->bcthv", rc * torch.exp(before),
                         torch.stack(states, dim=1))
    return o.reshape(B, nc * L, H, Vd)[:, :T]


def wkv_by_token(r, k, v, logw, u):
    """The recurrence one position at a time (the test's oracle)."""
    B, T, H, K = r.shape
    s = r.new_zeros((B, H, K, v.shape[-1]))
    outs = []
    for t in range(T):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, s) +
                    torch.einsum("bhk,bhk->bh", rt, u * kt)[..., None] * vt)
        s = s * torch.exp(logw[:, t])[..., None] + \
            torch.einsum("bhk,bhv->bhkv", kt, vt)
    return torch.stack(outs, dim=1)


def time_mix(cfg, p, h, prec: Precision):
    B, T, D = h.shape
    hd = cfg["head_dim"]
    H = D // hd
    hs = common.token_shift(h)

    def mix(c):
        return h + (hs - h) * p[f"mu_{c}"]

    r, k, v = (prec.mm(mix(c), p[n]).reshape(B, T, H, hd)
               for c, n in (("r", "Wr"), ("k", "Wk"), ("v", "Wv")))
    g = F.silu(prec.mm(mix("g"), p["Wg"]))
    w = prec.mm(prec.mm(mix("w"), p["w_lora_a"]), p["w_lora_b"]) + \
        p["w_bias"]
    logw = torch.clamp(-F.softplus(-w) - 0.5, LOGW_MIN, 0.0)
    o = wkv(r, k, v, logw.reshape(B, T, H, hd), p["u"]).reshape(B, T, D)
    return prec.mm(common.rmsnorm(o, p["ln_out"]) * g, p["Wo"])


def channel_mix(p, h, prec: Precision):
    hs = common.token_shift(h)
    kk = torch.square(torch.relu(prec.mm(h + (hs - h) * p["mu_k"], p["Wk"])))
    return torch.sigmoid(prec.mm(h, p["Wr"])) * prec.mm(kk, p["Wv"])


def block(cfg, p, x, prec: Precision):
    x = x + time_mix(cfg, p["mixer"]["tm"],
                     common.rmsnorm(x, p["ln1"]["scale"]), prec)
    return x + channel_mix(p["ffn"], common.rmsnorm(x, p["ln2"]["scale"]),
                           prec)


def _unstack(tree):
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


@torch.no_grad()
def serve_logits(cfg: dict, params, tokens, prompt_len: int,
                 prec: Precision = common.FLOAT32):
    """float32 logits (B, T - prompt_len + 1, V) after each of positions
    prompt_len - 1 .. T - 1 of tokens (B, T)."""
    x = params["embed"][tokens].float()
    for i in range(cfg["n_layers"]):
        x = block(cfg, common.layer_params(params["layers"], i), x, prec)
    x = common.rmsnorm(x[:, prompt_len - 1:], params["final_norm"]["scale"])
    return prec.mm(x, params["lm_head"].float().t())


def train_loss(cfg: dict, params, tokens, labels,
               prec: Precision = common.FLOAT32):
    """Mean cross entropy; params float32 leaves, one checkpoint a layer."""
    x = params["embed"][tokens]
    for lp in _unstack(params["layers"]):
        x = checkpoint(lambda x, lp=lp: block(cfg, lp, x, prec), x,
                       use_reentrant=False)
    x = common.rmsnorm(x, params["final_norm"]["scale"])
    return common.cross_entropy(x, params["lm_head"], labels, prec)
