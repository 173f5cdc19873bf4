"""Plain float32 reference of the DeepSeekMoE decoder (arXiv:2401.06066) as
the configuration file states it: pre-norm RMSNorm blocks, multi-head
attention with rotary positions (the two halves of each head rotated),
dense GLU first layers, then MoE layers of shared experts plus top-k routed
experts, and an untied output head.

Routing follows the served model's capacity semantics: within one dispatch
group (the tokens of one call of the model), each expert takes at most
C = max(8, ceil(n k 1.25 / E)) of the n k (token, slot) pairs routed to it,
in token order (row-major over batch and position); pairs beyond that are
dropped; the top-k weights are renormalised to sum to one.  A served wave
is one group for its prompt (every row's prompt positions together) and
one group for each decoded position; a training batch is one group.

`param_layout` is the parameter tree the benchmark makes from the seed
(the program's layout); the functions read it as given, in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference import common
from reference.common import F32, Precision

CAPACITY_FACTOR = 1.25
MIN_CAPACITY = 8


def _leaf(shape, dtype="bfloat16", init="normal", scale=None):
    if scale is None and init == "normal":
        scale = 1.0 / math.sqrt(shape[-2])
    return {"shape": list(shape), "dtype": dtype, "init": init,
            "scale": scale}


def _stack(tree, n):
    if "shape" in tree:
        return dict(tree, shape=[n] + tree["shape"], stacked=True)
    return {k: _stack(v, n) for k, v in tree.items()}


def param_layout(cfg: dict) -> dict:
    """The parameter tree: name -> {shape, dtype, init, scale}, and
    `stacked` on a leaf whose first axis is the layer axis."""
    D, H, hd, V = cfg["d_model"], cfg["n_heads"], cfg["head_dim"], \
        cfg["vocab"]
    m = cfg["moe"]
    n_dense = m["first_dense_layers"]

    def attn():
        return {"wq": _leaf((D, H * hd)), "wk": _leaf((D, H * hd)),
                "wv": _leaf((D, H * hd)), "wo": _leaf((H * hd, D))}

    def glu(f):
        return {"gate": _leaf((D, f)), "up": _leaf((D, f)),
                "down": _leaf((f, D))}

    norm = {"scale": _leaf((D,), init="ones")}
    E, Fe = m["n_routed"], m["d_ff_expert"]
    moe = {"router": _leaf((D, E), dtype="float32"),
           "gate": _leaf((E, D, Fe)), "up": _leaf((E, D, Fe)),
           "down": _leaf((E, Fe, D)),
           "shared": glu(Fe * m["n_shared"])}
    out = {"embed": _leaf((V, D), scale=0.02),
           "final_norm": norm,
           "lm_head": _leaf((V, D), scale=0.02),
           "layers": _stack({"ln1": norm, "mixer": attn(), "ln2": norm,
                             "ffn": moe}, cfg["n_layers"] - n_dense)}
    if n_dense:
        out["dense_layers"] = _stack(
            {"ln1": norm, "mixer": attn(), "ln2": norm,
             "ffn": glu(m["d_ff_dense"])}, n_dense)
    return out


def capacity(n: int, top_k: int, n_experts: int) -> int:
    return max(MIN_CAPACITY,
               math.ceil(n * top_k * CAPACITY_FACTOR / n_experts))


def route(p, x, top_k: int, prec: Precision):
    """One dispatch group x (n, D): (probs (n, E), expert (n k,), weight
    (n k,), kept (n k,)), pairs in token-major order."""
    n = x.shape[0]
    E = p["router"].shape[-1]
    probs = torch.softmax(prec.mm(x, p["router"]), dim=-1)
    w, e = torch.topk(probs, top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    e = e.reshape(-1)
    seen = torch.cumsum(F.one_hot(e, E), dim=0)              # (n k, E)
    rank = torch.gather(seen, 1, e[:, None])[:, 0] - 1
    return probs, e, w.reshape(-1), rank < capacity(n, top_k, E)


def moe_group(p, x, top_k: int, prec: Precision):
    """Routed experts of one dispatch group x (n, D) and the group's
    load-balance loss."""
    n = x.shape[0]
    E = p["router"].shape[-1]
    probs, e, w, kept = route(p, x, top_k, prec)
    tok = torch.arange(n * top_k, device=x.device) // top_k
    out = torch.zeros_like(x)
    for j in range(E):
        sel = torch.nonzero((e == j) & kept)[:, 0]
        if sel.numel() == 0:
            continue
        xe = x[tok[sel]]
        ye = prec.mm(F.silu(prec.mm(xe, p["gate"][j])) *
                     prec.mm(xe, p["up"][j]), p["down"][j])
        out = out.index_add(0, tok[sel], ye * w[sel, None])
    frac = torch.bincount(e, minlength=E).float() / (n * top_k)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return out, aux


def moe(p, x, groups, top_k: int, prec: Precision):
    """x (B, T, D); groups: (lo, hi) position ranges, each one dispatch
    group over every row.  Returns (shared + routed output, aux summed)."""
    B, T, D = x.shape
    out = common.glu(p["shared"], x, prec)
    routed, aux = [], 0.0
    for lo, hi in groups:
        y, a = moe_group(p, x[:, lo:hi].reshape(-1, D), top_k, prec)
        routed.append(y.reshape(B, hi - lo, D))
        aux = aux + a
    return out + torch.cat(routed, dim=1), aux


def block(cfg, p, x, positions, groups, prec: Precision, moe_layer: bool):
    B, T, D = x.shape
    H, hd = cfg["n_heads"], cfg["head_dim"]
    h = common.rmsnorm(x, p["ln1"]["scale"])
    a = p["mixer"]
    q, k, v = (prec.mm(h, a[n]).reshape(B, T, H, hd)
               for n in ("wq", "wk", "wv"))
    q, k = (common.rope(t, positions, cfg["rope_theta"]) for t in (q, k))
    att = common.causal_attention(q, k, v, prec).reshape(B, T, H * hd)
    x = x + prec.mm(att, a["wo"])
    h = common.rmsnorm(x, p["ln2"]["scale"])
    if moe_layer:
        y, aux = moe(p["ffn"], h, groups, cfg["moe"]["top_k"], prec)
    else:
        y, aux = common.glu(p["ffn"], h, prec), None
    return x + y, aux


def _stacks(params):
    """(group name, stacked tree, MoE layer?) in the order of the model."""
    out = []
    if "dense_layers" in params:
        out.append(("dense_layers", params["dense_layers"], False))
    out.append(("layers", params["layers"], True))
    return out


def _unstack(tree):
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


@torch.no_grad()
def serve_logits(cfg: dict, params, tokens, prompt_len: int,
                 prec: Precision = common.FLOAT32):
    """float32 logits (B, T - prompt_len + 1, V) of a served wave: tokens
    (B, T), the left-padded prompts then the tokens fed back, predicting
    the token after each of positions prompt_len - 1 .. T - 1."""
    T = tokens.shape[1]
    groups = [(0, prompt_len)] + [(t, t + 1) for t in range(prompt_len, T)]
    pos = torch.arange(T, device=tokens.device)
    x = params["embed"][tokens].float()
    for _, stack, is_moe in _stacks(params):
        n = next(iter(_leaves(stack))).shape[0]
        for i in range(n):
            x, _ = block(cfg, common.layer_params(stack, i), x, pos, groups,
                         prec, is_moe)
    x = common.rmsnorm(x[:, prompt_len - 1:], params["final_norm"]["scale"])
    return prec.mm(x, params["lm_head"].float().t())


def train_loss(cfg: dict, params, tokens, labels,
               prec: Precision = common.FLOAT32):
    """Mean cross entropy plus 0.01 times the load-balance loss summed over
    the MoE layers; params float32 leaves (differentiable), one checkpoint
    a layer."""
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    x = params["embed"][tokens]
    aux = x.new_zeros((), dtype=F32)
    for _, stack, is_moe in _stacks(params):
        for lp in _unstack(stack):
            def run(x, lp=lp, is_moe=is_moe):
                y, a = block(cfg, lp, x, pos, [(0, S)], prec, is_moe)
                return y, (a if a is not None else y.new_zeros(()))
            x, a = checkpoint(run, x, use_reentrant=False)
            aux = aux + a
    x = common.rmsnorm(x, params["final_norm"]["scale"])
    ce = common.cross_entropy(x, params["lm_head"], labels, prec)
    return ce + 0.01 * aux


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree
