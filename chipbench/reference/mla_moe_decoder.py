"""Plain float32 reference of DeepSeek-V2 (arXiv:2405.04434) as the
configuration file states it: pre-norm RMSNorm blocks of multi-head latent
attention (MLA) and a dense GLU first layer, then MoE layers of shared
experts plus routed experts, and an untied output head.

MLA, for each position: the query through its low-rank path, q =
RMSNorm(x wq_a) wq_b (or x wq without `q_lora`), split per head into a
part without positions (qk_nope) and a rotary part (qk_rope); the key and
value latent c = RMSNorm((x wkv_a)[:kv_lora]) and one rotary key shared
by every head, (x wkv_a)[kv_lora:]; per head k = [c wk_b, rotary key],
v = c wv_b.  Causal softmax attention over the whole sequence (no cache,
no absorption), its scores times (qk_nope + qk_rope) ** -1/2 and YaRN's
m(factor, mscale_all_dim) squared.  Rotary positions turn the two halves
of the rotary part (the published checkpoint turns interleaved pairs: on
seeded weights, a fixed permutation of the rotary columns of `wq_b` and
`wkv_a`), at YaRN's frequencies: base ** (-2i / d) below the correction
dim of `beta_fast` (floored), the same over `factor` above that of
`beta_slow` (ceiled), a linear ramp between, cos and sin times
m(factor, mscale) / m(factor, mscale_all_dim), m(s, a) = 0.1 a ln s + 1.

Routing: the softmax over the routed experts in float32; with `n_group`,
each group of experts scores its best probability, the `topk_group` best
groups are kept and the top-k experts come from theirs; the weights are
renormalised only where `norm_topk` is true, then multiplied by
`routed_scaling`.  Capacity as the served model's (`moe_decoder`): within
one dispatch group, each expert takes at most C = max(8, ceil(n k 1.25 /
E)) of its (token, slot) pairs in token order, the rest dropped; a served
wave is one group for its prompt and one for each decoded position.

`param_layout` is the parameter tree the benchmark makes from the seed
(the program's layout): normal draws at 1 / sqrt(fan_in), the embedding
and the head at 0.02, the norms 1, and the routed experts' down
projections at 1 / (routed_scaling sqrt(fan_in)).  Drawn at 1 /
sqrt(fan_in), the routed experts would add 16 times the shared experts'
output through a discrete choice, and the seeded model would be chaotic:
bfloat16 rounding alone moves the routing and, over 30 layers, puts the
served tokens as far from the float32 reference as float8 products do.  `serve_logits` reads a whole tree;
`serve_logits_by_leaf` draws each piece itself, a layer at a time, so the
whole model is never held, and spreads the work over the devices it is
given: each takes a block of the batch's rows for attention, the dense
products and the shared experts, and a share of the routed experts for
every row.  With one device both compute the same thing in the same
order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import common
from reference.common import F32, Precision
from reference.moe_decoder import _leaf, _stack, capacity


def param_layout(cfg: dict) -> dict:
    """The parameter tree: name -> {shape, dtype, init, scale}, and
    `stacked` on a leaf whose first axis is the layer axis."""
    D, H, V = cfg["d_model"], cfg["n_heads"], cfg["vocab"]
    a, m = cfg["mla"], cfg["moe"]
    qk = a["qk_nope"] + a["qk_rope"]
    n_dense = m["first_dense_layers"]
    ones = {"init": "ones"}

    def mla():
        if a.get("q_lora"):
            q = {"wq_a": _leaf((D, a["q_lora"])),
                 "q_norm": _leaf((a["q_lora"],), **ones),
                 "wq_b": _leaf((a["q_lora"], H * qk))}
        else:
            q = {"wq": _leaf((D, H * qk))}
        return {**q, "wkv_a": _leaf((D, a["kv_lora"] + a["qk_rope"])),
                "kv_norm": _leaf((a["kv_lora"],), **ones),
                "wk_b": _leaf((a["kv_lora"], H * a["qk_nope"])),
                "wv_b": _leaf((a["kv_lora"], H * a["v_dim"])),
                "wo": _leaf((H * a["v_dim"], D))}

    def glu(f):
        return {"gate": _leaf((D, f)), "up": _leaf((D, f)),
                "down": _leaf((f, D))}

    norm = {"scale": _leaf((D,), **ones)}
    E, Fe = m["n_routed"], m["d_ff_expert"]
    # the routed experts' output is drawn 1 / routed_scaling the size of
    # the shared experts', so that the factor brings it back to theirs
    down = 1.0 / (m.get("routed_scaling", 1.0) * math.sqrt(Fe))
    moe = {"router": _leaf((D, E), dtype="float32"),
           "gate": _leaf((E, D, Fe)), "up": _leaf((E, D, Fe)),
           "down": _leaf((E, Fe, D), scale=down),
           "shared": glu(Fe * m["n_shared"])}
    out = {"embed": _leaf((V, D), scale=0.02),
           "final_norm": norm,
           "lm_head": _leaf((V, D), scale=0.02),
           "layers": _stack({"ln1": norm, "mixer": mla(), "ln2": norm,
                             "ffn": moe}, cfg["n_layers"] - n_dense)}
    if n_dense:
        out["dense_layers"] = _stack(
            {"ln1": norm, "mixer": mla(), "ln2": norm,
             "ffn": glu(m["d_ff_dense"])}, n_dense)
    return out


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------

def yarn_m(factor: float, a: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * a * math.log(factor) + 1.0


def inv_freq(d: int, theta: float, scaling: dict | None, device):
    """(d/2 inverse frequencies, the factor on cos and sin)."""
    i = torch.arange(d // 2, dtype=F32, device=device)
    extra = theta ** (-2 * i / d)
    if not scaling:
        return extra, 1.0
    s, L0 = scaling["factor"], scaling["original_max_position_embeddings"]

    def corr(rot):
        return d * math.log(L0 / (2 * math.pi * rot)) / (2 * math.log(theta))
    low = max(math.floor(corr(scaling["beta_fast"])), 0)
    high = min(math.ceil(corr(scaling["beta_slow"])), d - 1)
    ramp = ((i - low) / max(high - low, 1e-3)).clamp(0, 1)
    inv = extra / s * ramp + extra * (1 - ramp)
    return inv, yarn_m(s, scaling.get("mscale", 1)) / \
        yarn_m(s, scaling.get("mscale_all_dim", 1))


def rotate(x, positions, inv, mscale: float):
    """Turn the two halves of x's last axis (B, T, H, d) by position times
    `inv`, cos and sin times `mscale`."""
    d = x.shape[-1]
    ang = positions.to(F32)[:, None] * inv[None, :]          # (T, d/2)
    cos = torch.cos(ang)[:, None] * mscale
    sin = torch.sin(ang)[:, None] * mscale
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def softmax_scale(cfg: dict) -> float:
    a, sc = cfg["mla"], cfg.get("rope_scaling")
    scale = (a["qk_nope"] + a["qk_rope"]) ** -0.5
    if sc and sc.get("mscale_all_dim"):
        scale *= yarn_m(sc["factor"], sc["mscale_all_dim"]) ** 2
    return scale


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def causal_attention(q, k, v, scale: float, prec: Precision,
                     block: int = 512):
    """Softmax attention with a causal mask, q, k (B, T, H, Dk), v (B, T,
    H, Dv), in blocks of query rows, each against the keys up to its
    last."""
    B, T, H, _ = q.shape
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, T, D)
    outs = []
    for lo in range(0, T, block):
        hi = min(lo + block, T)
        s = prec.mm(qh[:, :, lo:hi], kh[:, :, :hi].transpose(-1, -2)) * scale
        qpos = torch.arange(lo, hi, device=q.device)
        kpos = torch.arange(hi, device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
        outs.append(prec.mm(torch.softmax(s, dim=-1), vh[:, :, :hi]))
    return torch.cat(outs, dim=2).transpose(1, 2)             # (B, T, H, Dv)


def mla(cfg: dict, w, h, positions, prec: Precision):
    """MLA over the whole sequence h (B, T, D), float32 weights `w`."""
    B, T, _ = h.shape
    a, H = cfg["mla"], cfg["n_heads"]
    nope, rd, kvl = a["qk_nope"], a["qk_rope"], a["kv_lora"]
    inv, msc = inv_freq(rd, cfg["rope_theta"], cfg.get("rope_scaling"),
                        h.device)
    if "wq_a" in w:
        q = prec.mm(common.rmsnorm(prec.mm(h, w["wq_a"]), w["q_norm"]),
                    w["wq_b"])
    else:
        q = prec.mm(h, w["wq"])
    q = q.reshape(B, T, H, nope + rd)
    q = torch.cat([q[..., :nope], rotate(q[..., nope:], positions, inv,
                                          msc)], dim=-1)
    kv = prec.mm(h, w["wkv_a"])
    c = common.rmsnorm(kv[..., :kvl], w["kv_norm"])
    kr = rotate(kv[..., kvl:][:, :, None], positions, inv, msc)
    k = torch.cat([prec.mm(c, w["wk_b"]).reshape(B, T, H, nope),
                   kr.expand(B, T, H, rd)], dim=-1)
    v = prec.mm(c, w["wv_b"]).reshape(B, T, H, a["v_dim"])
    att = causal_attention(q, k, v, softmax_scale(cfg), prec)
    return prec.mm(att.reshape(B, T, -1), w["wo"])


def route(cfg: dict, router, x, prec: Precision):
    """One dispatch group x (n, D): (expert (n k,), weight (n k,), kept
    (n k,)), pairs in token-major order."""
    m = cfg["moe"]
    n, E, k = x.shape[0], router.shape[-1], m["top_k"]
    probs = torch.softmax(prec.mm(x, router), dim=-1)
    if m.get("n_group"):
        g = m["n_group"]
        best = probs.reshape(n, g, E // g).amax(dim=-1)
        top = torch.topk(best, m["topk_group"], dim=-1).indices
        keep = torch.zeros_like(best).scatter_(1, top, 1.0) > 0
        probs = probs * keep[:, :, None].expand(n, g, E // g).reshape(n, E)
    w, e = torch.topk(probs, k, dim=-1)
    if m.get("norm_topk", True):
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    w = w * m.get("routed_scaling", 1.0)
    e = e.reshape(-1)
    seen = torch.cumsum(F.one_hot(e, E), dim=0)              # (n k, E)
    rank = torch.gather(seen, 1, e[:, None])[:, 0] - 1
    return e, w.reshape(-1), rank < capacity(n, k, E)


# ---------------------------------------------------------------------------
# the model over one or several devices
# ---------------------------------------------------------------------------

class _Parts:
    """The batch's rows in contiguous blocks (lo, hi), one a device."""

    def __init__(self, B: int, devices: list):
        self.devices = list(devices)[:B]
        n = len(self.devices)
        self.rows = [(B * d // n, B * (d + 1) // n) for d in range(n)]

    def __iter__(self):
        return iter(zip(self.rows, self.devices))


def _to(t, device):
    """A host tensor on `device`, without waiting for the device's queued
    work where it is a card."""
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _by_expert(e, kept, E: int):
    """(the kept pairs sorted by expert, each expert's first and end
    offset in it); within an expert in token-major order."""
    idx = torch.nonzero(kept)[:, 0]
    ek = e[idx]
    idx = idx[torch.argsort(ek, stable=True)]
    ends = torch.cumsum(torch.bincount(ek, minlength=E), 0).tolist()
    return idx, [0] + ends[:-1], ends


def _moe(cfg, fetch, h_parts, parts, groups, prec):
    """The routed experts of each dispatch group (every row, the positions
    of the group), device d computing experts d, d + n, ... (n devices)
    for every row; returns each device's rows of the routed output."""
    E, k = cfg["moe"]["n_routed"], cfg["moe"]["top_k"]
    devs = parts.devices
    n_dev = len(devs)
    experts = [{n: fetch(("ffn", n), dev, slice(d, None, n_dev))
                for n in ("gate", "up", "down")}
               for d, dev in enumerate(devs)]
    router = fetch(("ffn", "router"), devs[0])
    outs = [[] for _ in devs]
    for lo, hi in groups:
        whole = [torch.cat([h[:, lo:hi].to(dev) for h in h_parts])
                 for dev in devs]                           # (B, L, D) each
        B, L, D = whole[0].shape
        e, w, kept = (t.cpu() for t in route(
            cfg, router, whole[0].reshape(B * L, D), prec))
        idx, first, end = _by_expert(e, kept, E)
        for d, dev in enumerate(devs):
            x = whole[d].reshape(B * L, D)
            pairs = _to(idx, dev)
            tok, wt = pairs // k, _to(w, dev)[pairs]
            out = torch.zeros_like(x)
            p = experts[d]
            for j, ex in enumerate(range(d, E, n_dev)):
                a, b = first[ex], end[ex]
                if a == b:
                    continue
                xe = x.index_select(0, tok[a:b])
                ye = prec.mm(F.silu(prec.mm(xe, p["gate"][j])) *
                             prec.mm(xe, p["up"][j]), p["down"][j])
                out = out.index_add(0, tok[a:b], ye * wt[a:b, None])
            outs[d].append(out.reshape(B, L, D))
        del whole
    per_dev = [torch.cat(o, dim=1) for o in outs]           # (B, T, D)
    result = []
    for (r0, r1), dev in parts:
        acc = None
        for o in per_dev:
            part = o[r0:r1].to(dev)
            acc = part if acc is None else acc + part
        result.append(acc)
    return result


def _block(cfg, fetch, x_parts, parts, positions, groups, prec,
           moe_layer: bool):
    out = []
    h2_parts = []
    for x, pos, (_, dev) in zip(x_parts, positions, parts):
        mix = {n: fetch(("mixer", n), dev) for n in
               ("wq_a", "q_norm", "wq_b", "wq", "wkv_a", "kv_norm", "wk_b",
                "wv_b", "wo") if fetch.has(("mixer", n))}
        h = common.rmsnorm(x, fetch(("ln1", "scale"), dev))
        x = x + mla(cfg, mix, h, pos, prec)
        del mix, h
        h2 = common.rmsnorm(x, fetch(("ln2", "scale"), dev))
        if moe_layer:
            shared = {n: fetch(("ffn", "shared", n), dev)
                      for n in ("gate", "up", "down")}
        else:
            shared = {n: fetch(("ffn", n), dev)
                      for n in ("gate", "up", "down")}
        out.append(x + common.glu(shared, h2, prec))
        h2_parts.append(h2)
    if moe_layer:
        routed = _moe(cfg, fetch, h2_parts, parts, groups, prec)
        out = [x + y for x, y in zip(out, routed)]
    return out


class _Fetch:
    """One layer's pieces, float32, on the device asked: `draw(path,
    device, layer)` of the group's path; `rows` (a slice) keeps those of
    a piece's first axis (a device's routed experts)."""

    def __init__(self, draw, layout: dict, group: str, layer: int):
        self.draw, self.layout = draw, layout[group]
        self.group, self.layer = group, layer

    def has(self, path) -> bool:
        node = self.layout
        for p in path:
            if p not in node:
                return False
            node = node[p]
        return True

    def __call__(self, path, device, rows=None):
        t = self.draw((self.group,) + tuple(path), device, self.layer)
        return (t if rows is None else t[rows]).float()


def _layers(layout: dict) -> list:
    """(group name, layer count, MoE layer?) in the order of the model."""
    def count(tree):
        while "shape" not in tree:
            tree = next(iter(tree.values()))
        return tree["shape"][0]
    out = []
    if "dense_layers" in layout:
        out.append(("dense_layers", count(layout["dense_layers"]), False))
    out.append(("layers", count(layout["layers"]), True))
    return out


@torch.no_grad()
def serve_logits_by_leaf(cfg: dict, draw, tokens, prompt_len: int,
                         prec: Precision = common.FLOAT32, devices=None):
    """float32 logits (B, T - prompt_len + 1, V) of a served wave: tokens
    (B, T), the left-padded prompts then the tokens fed back, predicting
    the token after each of positions prompt_len - 1 .. T - 1.  `draw(path,
    device, layer)` gives a piece of the weights in its own dtype: a leaf
    whole (`layer` None) or one layer of a stacked leaf; the work spreads
    over `devices` (the device of `tokens` alone by default)."""
    B, T = tokens.shape
    parts = _Parts(B, devices or [tokens.device])
    layout = param_layout(cfg)
    groups = [(0, prompt_len)] + [(t, t + 1) for t in range(prompt_len, T)]
    positions = [torch.arange(T, device=dev) for dev in parts.devices]
    x_parts = []
    for (r0, r1), dev in parts:
        embed = draw(("embed",), dev, None)
        x_parts.append(embed[tokens[r0:r1].to(dev)].float())
        del embed
    for group, n, is_moe in _layers(layout):
        for i in range(n):
            x_parts = _block(cfg, _Fetch(draw, layout, group, i), x_parts,
                             parts, positions, groups, prec, is_moe)
    first = parts.devices[0]
    out = []
    for x, (_, dev) in zip(x_parts, parts):
        x = common.rmsnorm(x[:, prompt_len - 1:],
                           draw(("final_norm", "scale"), dev, None).float())
        out.append(prec.mm(x, draw(("lm_head",), dev, None).float().t())
                   .to(first))
    return torch.cat(out)


def serve_logits(cfg: dict, params, tokens, prompt_len: int,
                 prec: Precision = common.FLOAT32):
    """`serve_logits_by_leaf` over a whole parameter tree, on the device of
    `tokens`."""
    def draw(path, device, layer):
        t = params
        for p in path:
            t = t[p]
        return (t if layer is None else t[layer]).to(device)
    return serve_logits_by_leaf(cfg, draw, tokens, prompt_len, prec)
