"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), from the JAX
package's `repro/models/encdec.py`.

The audio conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, enc_len, D).  Positions are sinusoidal
(parameter-free).  The stacks are Python loops over the stacked layers
(views, no copies), and the decoder's caches are written in place.
`remat` (training) checkpoints each layer of both stacks, saving nothing,
as the reference's `nothing_saveable` does whatever policy it is given.

`kernels=True` runs the encoder's attention, the decoder's self attention
and its cross attention through the flash attention kernel, and the
decoder's self attention at a decode step through the decode attention
kernel (`layernorm` has no kernel).  `None` means the kernels on the card
and the plain math on the CPU.

As in the reference, a decoder given caches reads cross K/V from
`cache["cross_k"]` / `cache["cross_v"]`, which nothing fills from the
encoder output: on the cached (serving) path the encoder output reaches no
logit (ROADMAP queue 3, item 7).  Only the uncached path (`caches=None`)
projects the encoder output into cross K/V.

With a `mesh`, both stacks take the batch whole on every rank and run this
rank's rows (split as `transformer.decoder_forward` splits them), on
parameter blocks laid out by `transformer.param_shardings`, each layer
gathered over the batch axes before use; `encode` returns this rank's rows
of the encoder output, which `decode_stack` takes.  As in the decoders,
the attention blocks (encoder, self and cross) and the GELU FFNs that the
layout splits over "model" (`transformer.split_blocks`) run
tensor-parallel, the cross attention's K/V from this rank's KV heads of
`wk`/`wv` (or of the cache), and a vocabulary split over "model"
(`transformer.vocab_tp`) gives a masked embedding lookup summed over
"model".
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import gelu_mlp, gelu_mlp_specs, layernorm
from repro_torch.models.module import ParamSpec, stack_specs
from repro_torch.models.transformer import (_index, _layer_gather, _unstack,
                                            embed_lookup, param_shardings,
                                            remat_layer, resolve_kernels,
                                            split_batch, vocab_table,
                                            vocab_tp)
from repro_torch.sharding.collectives import copy_to, gather_params

F32 = torch.float32


def sinusoidal(positions, d_model: int):
    """positions: (B,S) -> (B,S,D) float32."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=F32, device=positions.device) / (half - 1))
    args = positions[..., None].to(F32) * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _ln_specs(cfg):
    return {"scale": ParamSpec((cfg.d_model,), cfg.dtype, (None,), init="ones"),
            "bias": ParamSpec((cfg.d_model,), cfg.dtype, (None,), init="zeros")}


def enc_layer_specs(cfg: ArchConfig):
    return {
        "ln1": _ln_specs(cfg),
        "attn": attn.gqa_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.dtype),
        "ln2": _ln_specs(cfg),
        "ffn": gelu_mlp_specs(cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def dec_layer_specs(cfg: ArchConfig):
    return {
        "ln1": _ln_specs(cfg),
        "self": attn.gqa_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.dtype),
        "lnx": _ln_specs(cfg),
        "cross": attn.gqa_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, cfg.dtype),
        "ln2": _ln_specs(cfg),
        "ffn": gelu_mlp_specs(cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def whisper_param_specs(cfg: ArchConfig):
    enc_layers = cfg.enc["enc_layers"]
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), cfg.dtype,
                           ("vocab", None), scale=0.02),
        "enc_layers": stack_specs(enc_layer_specs(cfg), enc_layers),
        "enc_norm": _ln_specs(cfg),
        "dec_layers": stack_specs(dec_layer_specs(cfg), cfg.n_layers),
        "dec_norm": _ln_specs(cfg),
    }


def _ln(p, x):
    return layernorm(x, p["scale"], p["bias"])


def _placement(cfg, mesh, batch):
    """(dp, a function gathering a whole top-level leaf group, a function
    giving a stacked group's `_layer_gather`) for `mesh` (identities
    without one)."""
    dp, *_ = split_batch(mesh, batch)
    if mesh is None:
        return dp, (lambda params, name: params[name]), \
            (lambda name: (None, frozenset()))
    sh = param_shardings(cfg, mesh)
    return (dp, lambda params, name: gather_params(params[name], sh[name], dp),
            lambda name: _layer_gather(cfg, sh[name], dp, False))


def encode(cfg: ArchConfig, params, enc_embeds, *, mesh=None, kernels=None,
           remat=False):
    """enc_embeds: (B, enc_len, D) from the stub conv frontend."""
    kernels = resolve_kernels(kernels, enc_embeds.device)
    dp, whole, layer_gather = _placement(cfg, mesh, enc_embeds)
    if mesh is not None:
        enc_embeds = split_batch(mesh, enc_embeds)[1]
    gather, split = layer_gather("enc_layers")
    B, T, D = enc_embeds.shape
    pos = torch.arange(T, device=enc_embeds.device)[None].expand(B, T)
    x = enc_embeds + sinusoidal(pos, D).to(enc_embeds.dtype)

    def tp(name):
        return mesh if name in split else None

    def layer(x, lp):
        if gather is not None:
            lp = gather(lp)
        h = _ln(lp["ln1"], x)
        y, _ = attn.gqa_attention(lp["attn"], h, pos, n_heads=cfg.n_heads,
                                  n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                                  rope="none", causal=False, tp=tp("attn"),
                                  kernels=kernels)
        x = x + y
        return x + gelu_mlp(lp["ffn"], _ln(lp["ln2"], x), tp=tp("ffn"))

    layer = remat_layer(layer, bool(remat))
    for lp in _unstack(params["enc_layers"]):
        x = layer(x, lp)
    return _ln(whole(params, "enc_norm"), x)


def decode_stack(cfg: ArchConfig, params, tokens, enc_out, *, mesh=None,
                 caches=None, cur_len=None, kernels=None, remat=False):
    """tokens: (B,S). caches: dict(self_k/self_v (L,B,T,H,Dh),
    cross_k/cross_v (L,B,Tenc,H,Dh)), written in place, or None (the
    uncached forward, which projects `enc_out` into cross K/V; with caches
    `enc_out` is not read); cur_len: Python int or None; remat: checkpoint
    each layer (only without caches).

    Returns (hidden, caches)."""
    dp, whole, layer_gather = _placement(cfg, mesh, tokens)
    if mesh is not None:
        tokens = split_batch(mesh, tokens)[1]
    gather, split = layer_gather("dec_layers")
    embed = vocab_table(cfg, params, "embed", mesh, dp)
    kernels = resolve_kernels(kernels, embed.device)
    B, S = tokens.shape
    base = 0 if cur_len is None else cur_len
    pos = base + torch.arange(S, device=embed.device)[None].expand(B, S)
    x = embed_lookup(embed, tokens, vocab_tp(cfg, mesh))
    x = x + sinusoidal(pos, cfg.d_model).to(x.dtype)

    Dh = cfg.head_dim
    heads = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=Dh,
                 rope="none", kernels=kernels)

    def tp(name):
        return mesh if name in split else None

    def layer(x, lp, cache_l):
        if gather is not None:
            lp = gather(lp)
        h = _ln(lp["ln1"], x)
        self_cache = None
        if cache_l is not None:
            self_cache = {"k": cache_l["self_k"], "v": cache_l["self_v"]}
        y, _ = attn.gqa_attention(lp["self"], h, pos, causal=True,
                                  cache=self_cache, cur_len=cur_len,
                                  tp=tp("self"), **heads)
        x = x + y
        # cross attention to the encoder output, over this rank's KV heads
        h = _ln(lp["lnx"], x)
        lo, Hkv = attn.kv_range(cfg.n_heads, cfg.n_kv_heads, tp("cross"))
        if cache_l is not None:
            ck, cv = (cache_l[n][:, :, lo:lo + Hkv]
                      for n in ("cross_k", "cross_v"))
        else:
            Te = enc_out.shape[1]
            e = enc_out if tp("cross") is None else \
                copy_to(enc_out, mesh, "model")
            ck, cv = ((e @ attn.kv_cols(lp["cross"][n], lo, Hkv, Dh))
                      .reshape(B, Te, Hkv, Dh) for n in ("wk", "wv"))
        y, _ = attn.gqa_attention(lp["cross"], h, pos, cross_kv=(ck, cv),
                                  tp=tp("cross"), **heads)
        x = x + y
        return x + gelu_mlp(lp["ffn"], _ln(lp["ln2"], x), tp=tp("ffn"))

    layer = remat_layer(layer, bool(remat) and caches is None)
    for i, lp in enumerate(_unstack(params["dec_layers"])):
        x = layer(x, lp, None if caches is None else _index(caches, i))
    return _ln(whole(params, "dec_norm"), x), caches


def whisper_cache_specs(cfg: ArchConfig, batch: int, max_len: int):
    L = cfg.n_layers
    Te = cfg.enc["enc_len"]

    def kv(T):
        return ParamSpec((L, batch, T, cfg.n_kv_heads, cfg.head_dim),
                         cfg.dtype, (None, "batch", "kv_seq", "kv_heads", None),
                         init="zeros")

    return {"self_k": kv(max_len), "self_v": kv(max_len),
            "cross_k": kv(Te), "cross_v": kv(Te)}
