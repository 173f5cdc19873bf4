"""Decoder-only LM assembly, from the JAX package's
`repro/models/transformer.py`: config-driven mixer (GQA / MLA / RWKV6 /
Mamba2) + FFN (GLU / GELU / fine-grained MoE / RWKV channel-mix), pre-norm
residual blocks, the Zamba2 hybrid stack with its shared attention block,
the layer stacks as Python loops over the stacked parameters (views, no
copies), and prefill / decode paths with per-layer caches written in place:
KV and latent caches by slice assignment, recurrent state (`state`,
`conv`, `last_tm`, `last_cm`) by `copy_` into the stacked cache's views.

Qwen2-VL's M-RoPE takes `mrope_positions` (3, B, S); without them the text
positions drive all three streams, as in the reference.  The encoder-decoder
(whisper) has its own stacks in `repro_torch.models.encdec`.

Training: `decoder_forward` returns the MoE load-balance loss summed over
layers beside the hidden state, and takes `remat` (`REMAT_POLICIES`: one
`torch.utils.checkpoint` a layer, saving nothing, the matmuls or the tagged
block outputs); `chunked_ce_loss` is the reference's sequence-blocked
cross entropy, each block under its own checkpoint, so the (B, S, V)
logits never live at once.  A stacked parameter group is split into its
layers by one `unbind` a leaf, whose backward stacks the layers' gradients
at once.

With a `mesh` (`sharding.rules.Mesh`), `decoder_forward` takes the whole
token batch on every rank and splits its rows over the data-parallel
axes (`rules.batch_axes`, the reference's `constrain(x, mesh, "batch",
...)` with its divisibility fallback); the parameters are this rank's
blocks by `param_shardings` (FSDP / ZeRO-3, as `rules.py` lays them out:
"embed" over "data"; "heads", "mlp" and "vocab" over "model"), each
layer's gathered over the batch axes just before use
(`collectives.gather_param`, inside the layer's checkpoint, so remat
gathers again).  The blocks that `split_blocks` names keep their "model"
split and run tensor-parallel, as GSPMD runs the reference's: GQA
(`attention.heads_split`), MLA (with low-rank queries a kind of its own,
"mla_lora", split by `wq_b`'s heads), Mamba2 and RWKV6's time mix on whole
heads, the GLU / GELU FFNs and RWKV's channel mix on d_ff, zamba2's
shared block as GQA and GLU; each is entered through `copy_to` and left
through one `reduce_from`.  A leaf whole over "model" that feeds a split
block's work (`PART_LEAVES`, per block kind) sums its gradient over
"model"; Mamba2's `in_proj` and `conv_w` come whole (`WHOLE_LEAVES`) and
the rank takes its heads' columns (`ssm.local_spans`).  The MoE experts'
d_ff stays split for `layers.moe_local`.  A block whose split would not
fall on whole heads is gathered whole over "model" too, the reference
layout's own fallback.  A vocabulary split over "model"
(`vocab_tp`) makes the embedding a masked lookup summed over "model", and
the head and `chunked_ce_loss` run on this rank's vocabulary rows.  The
hidden state returned holds this rank's rows, whole over "model".
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (gelu_mlp, gelu_mlp_specs, glu_mlp,
                                       glu_mlp_specs, layernorm, matmul_f32,
                                       moe_local, moe_specs, rmsnorm)
from repro_torch.models.module import ParamSpec, tree_map
from repro_torch.obs.realtime import device_tracer
from repro_torch.sharding.collectives import (copy_to, gather_param,
                                              gather_params, max_over,
                                              reduce_from, rows)
from repro_torch.sharding.rules import (P, NamedSharding, batch_axes,
                                        sharding_for, tree_shardings)

F32 = torch.float32


def check_supported(cfg: ArchConfig) -> None:
    """Raise ValueError for a configuration field the model code does not
    know (mixer gqa, mla, rwkv6 or mamba2; ffn glu, gelu, moe, rwkv_cm or
    none; rope, mrope or none; rms or ln norm)."""
    for field, ok in (("mixer", ("gqa", "mla", "rwkv6", "mamba2")),
                      ("ffn", ("glu", "gelu", "moe", "rwkv_cm", "none")),
                      ("rope", ("rope", "mrope", "none")),
                      ("norm", ("rms", "ln"))):
        if getattr(cfg, field) not in ok:
            raise ValueError(f"{cfg.name}: unknown {field} "
                             f"{getattr(cfg, field)!r}")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _norm_specs(cfg):
    if cfg.norm == "ln":
        return {"scale": ParamSpec((cfg.d_model,), cfg.dtype, (None,), init="ones"),
                "bias": ParamSpec((cfg.d_model,), cfg.dtype, (None,), init="zeros")}
    return {"scale": ParamSpec((cfg.d_model,), cfg.dtype, (None,), init="ones")}


def _apply_norm(cfg, p, x, *, kernels: bool = False):
    if cfg.norm == "ln":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"], kernels=kernels)


def mixer_specs(cfg: ArchConfig):
    if cfg.mixer == "gqa":
        return attn.gqa_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.dtype)
    if cfg.mixer == "mla":
        m = cfg.mla
        return attn.mla_specs(cfg.d_model, cfg.n_heads, m["qk_nope"],
                              m["qk_rope"], m["v_dim"], m["kv_lora"], cfg.dtype,
                              q_lora=m.get("q_lora"))
    if cfg.mixer == "rwkv6":
        return rwkv_mod.rwkv6_specs(cfg.d_model, cfg.head_dim, cfg.d_ff,
                                    cfg.dtype)
    if cfg.mixer == "mamba2":
        s = cfg.ssm
        return ssm_mod.mamba2_specs(cfg.d_model, s["d_state"], s["headdim"],
                                    s.get("expand", 2), cfg.dtype)
    raise ValueError(cfg.mixer)


def ffn_specs(cfg: ArchConfig, moe_layer: bool):
    if cfg.ffn == "none" or cfg.mixer == "rwkv6":  # rwkv owns its channel mix
        return {}
    if cfg.ffn == "moe" and moe_layer:
        m = cfg.moe
        return moe_specs(cfg.d_model, m["d_ff_expert"], m["n_routed"],
                         m["n_shared"], cfg.dtype)
    if cfg.ffn == "gelu":
        return gelu_mlp_specs(cfg.d_model, cfg.d_ff, cfg.dtype)
    d_ff = cfg.d_ff if cfg.ffn != "moe" else cfg.moe.get("d_ff_dense", cfg.d_ff)
    return glu_mlp_specs(cfg.d_model, d_ff, cfg.dtype)


def layer_specs(cfg: ArchConfig, moe_layer: bool = False):
    specs = {"ln1": _norm_specs(cfg), "mixer": mixer_specs(cfg)}
    fs = ffn_specs(cfg, moe_layer)
    if fs:
        specs["ln2"] = _norm_specs(cfg)
        specs["ffn"] = fs
    return specs


def shared_attn_specs(cfg: ArchConfig):
    """Zamba2-style shared transformer block (attention + GLU)."""
    return {
        "ln1": _norm_specs(cfg),
        "attn": attn.gqa_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.dtype),
        "ln2": _norm_specs(cfg),
        "ffn": glu_mlp_specs(cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def rwkv_layer_specs(cfg: ArchConfig):
    base = rwkv_mod.rwkv6_specs(cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.dtype)
    return {"ln1": _norm_specs(cfg), "mixer": {"tm": base["tm"]},
            "ln2": _norm_specs(cfg), "ffn": base["cm"]}


# ---------------------------------------------------------------------------
# single layer application
# ---------------------------------------------------------------------------

def apply_mixer(cfg: ArchConfig, p, x, positions, *, mesh=None, cache=None,
                cur_len=None, mrope_positions=None, kv_seq_shard=False,
                tp=None, kernels: bool = False):
    """Returns (y, cache); a recurrent mixer's new state is copied into the
    cache's views in place.  `tp`: the mixer's heads split over its
    "model" ranks (`attention.gqa_attention`, `attention.mla_attention`,
    `rwkv.rwkv6_time_mix`, `ssm.mamba2_block`); a recurrent mixer then
    reads and writes its heads of the cache's state (and Mamba2 its conv
    channels), which it takes as contiguous copies, as the scan kernels
    need them."""
    if cfg.mixer == "gqa":
        return attn.gqa_attention(
            p, x, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope=cfg.rope, rope_theta=cfg.rope_theta,
            mrope_sections=cfg.mrope_sections,
            mrope_positions=mrope_positions, cache=cache, cur_len=cur_len,
            mesh=mesh, kv_seq_shard=kv_seq_shard, tp=tp, kernels=kernels)
    if cfg.mixer == "mla":
        m = cfg.mla
        return attn.mla_attention(
            p, x, positions, n_heads=cfg.n_heads, qk_nope=m["qk_nope"],
            qk_rope=m["qk_rope"], v_dim=m["v_dim"], kv_lora=m["kv_lora"],
            rope_theta=cfg.rope_theta, rope_scaling=cfg.rope_scaling,
            cache=cache, cur_len=cur_len, tp=tp, kernels=kernels)
    if cfg.mixer == "rwkv6":
        state, last_tm = None, None
        if cache is not None:   # this rank's heads of the state (a copy)
            view = cache["state"] if tp is None else \
                rows(cache["state"], tp, "model", 1)
            state, last_tm = view.contiguous(), cache["last_tm"]
        y, (s_new, last_new) = rwkv_mod.rwkv6_time_mix(
            p["tm"], x, head_dim=cfg.head_dim, state=state, last_x=last_tm,
            tp=tp, kernels=kernels)
        if cache is not None:
            view.copy_(s_new)
            cache["last_tm"].copy_(last_new)
        return y, cache
    if cfg.mixer == "mamba2":
        s = cfg.ssm
        state = conv = None
        if cache is not None:
            views, (state, conv) = ssm_mod.local_cache(
                cache, s["d_state"], s["headdim"], tp)
        y, (s_new, conv_new) = ssm_mod.mamba2_block(
            p, x, d_state=s["d_state"], headdim=s["headdim"],
            state=state, conv_state=conv, tp=tp, kernels=kernels)
        if cache is not None:
            ssm_mod.store_local(views, s_new, conv_new)
        return y, cache
    raise ValueError(cfg.mixer)


def apply_layer(cfg: ArchConfig, p, x, positions, *, mesh=None, dp=(),
                moe_layer=False, cache=None, cur_len=None,
                mrope_positions=None, kv_seq_shard=False, split=frozenset(),
                kernels: bool = False, names: bool = False):
    """Pre-norm residual block. Returns (x, cache, aux_loss): the MoE
    layer's float32 load-balance loss, None for every other layer.
    `names` tags the mixer and FFN outputs for the "names" remat policy.
    With a `mesh`, x holds this rank's rows of a batch split over `dp` and
    `p` is whole but for the MoE experts' d_ff slice and the blocks named
    in `split` ("mixer", "ffn"), which hold this rank's heads or d_ff and
    run tensor-parallel over "model" (`decoder_forward`).  While a profiler
    records, the mixer and the FFN are the device channel's `model.mixer`
    and `model.ffn` spans."""
    aux = None
    tr = device_tracer()

    def tp(name):
        return mesh if name in split else None

    h = _apply_norm(cfg, p["ln1"], x, kernels=kernels)
    with tr.span("model.mixer"):
        y, cache = apply_mixer(cfg, p["mixer"], h, positions, mesh=mesh,
                               cache=cache, cur_len=cur_len,
                               mrope_positions=mrope_positions,
                               kv_seq_shard=kv_seq_shard, tp=tp("mixer"),
                               kernels=kernels)
    if names:
        y = checkpoint_name(y, "mixer_out")
    x = x + y
    if cfg.mixer == "rwkv6":
        # rwkv channel-mix with its own token shift
        last_cm = cache["last_cm"] if cache is not None else None
        h = _apply_norm(cfg, p["ln2"], x, kernels=kernels)
        with tr.span("model.ffn"):
            y, last_cm_new = rwkv_mod.rwkv6_channel_mix(p["ffn"], h, last_cm,
                                                        tp=tp("ffn"))
        if cache is not None:
            cache["last_cm"].copy_(last_cm_new)
        return x + y, cache, aux
    if "ffn" in p:
        h = _apply_norm(cfg, p["ln2"], x, kernels=kernels)
        with tr.span("model.ffn"):
            if cfg.ffn == "moe" and moe_layer:
                y, aux = moe_local(
                    p["ffn"], h, top_k=cfg.moe["top_k"], mesh=mesh, dp=dp,
                    impl=cfg.moe.get("impl", "capacity"),
                    capacity_factor=cfg.moe.get("capacity_factor", 1.25),
                    kernels=kernels, routing=cfg.moe)
            elif cfg.ffn == "gelu":
                y = gelu_mlp(p["ffn"], h, tp=tp("ffn"))
            else:
                y = glu_mlp(p["ffn"], h, tp=tp("ffn"))
        if names:
            y = checkpoint_name(y, "ffn_out")
        x = x + y
    return x, cache, aux


def apply_shared_attn(cfg: ArchConfig, p, x, positions, *, cache=None,
                      cur_len=None, mesh=None, split=frozenset(),
                      kernels: bool = False):
    """Zamba2 shared attention block (full attention, shared params).
    The blocks named in `split` ("attn", "ffn") hold this rank's heads or
    d_ff and run tensor-parallel over `mesh`'s "model" ranks."""
    def tp(name):
        return mesh if name in split else None

    h = _apply_norm(cfg, p["ln1"], x, kernels=kernels)
    y, cache = attn.gqa_attention(
        p["attn"], h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope=cfg.rope, rope_theta=cfg.rope_theta,
        cache=cache, cur_len=cur_len, tp=tp("attn"), kernels=kernels)
    x = x + y
    h = _apply_norm(cfg, p["ln2"], x, kernels=kernels)
    return x + glu_mlp(p["ffn"], h, tp=tp("ffn")), cache


# ---------------------------------------------------------------------------
# full decoder forward
# ---------------------------------------------------------------------------

def _index(tree, i):
    """Layer `i` of a stacked cache tree, as views."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree) -> list:
    """The layers of a stacked parameter tree, as views: one `unbind` a
    leaf, whose backward stacks all the layers' gradients in one tensor
    (indexing layer by layer would give each layer's gradient as a zero
    tensor of the whole stack)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


# ---------------------------------------------------------------------------
# activation checkpointing (the reference's `jax.checkpoint` policies)
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


_checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))


def checkpoint_name(x, name: str):
    """`jax.ad_checkpoint.checkpoint_name`: a copy of `x` through an op of
    its own, which the "names" policy saves."""
    return torch.ops.repro_torch.checkpoint_name(x, name)


# remat policy -> the ops whose outputs the checkpoint saves (every other
# op is recomputed in the backward pass)
REMAT_POLICIES = {
    # full: recompute everything in bwd (min memory, +1 fwd of compute)
    "full": (),
    # dots: save the outputs of products without batch dimensions (the
    # reference's dots_with_no_batch_dims_saveable): the weight GEMMs,
    # not the attention einsums or the batched expert GEMMs
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
    # names: save only the d-model-sized block outputs tagged in
    # `apply_layer` (save_only_these_names("mixer_out", "ffn_out"))
    "names": (torch.ops.repro_torch.checkpoint_name.default,),
}


def remat_layer(fn, remat):
    """`fn` under the remat policy `remat` (False | True/"full" | "dots" |
    "names"): one `torch.utils.checkpoint` a call."""
    if not remat:
        return fn
    saved = REMAT_POLICIES["full" if remat is True else remat]
    kw = {"use_reentrant": False}
    if saved:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(saved))
    return functools.partial(checkpoint, fn, **kw)


def param_shardings(cfg: ArchConfig, mesh):
    """The layout of the parameters a call with `mesh` takes: the
    reference's `tree_shardings(build_param_specs(cfg), mesh)`."""
    from repro_torch.models.zoo import build_param_specs
    return tree_shardings(build_param_specs(cfg), mesh)


def layer_shardings(stacked):
    """One layer's shardings from a stacked group's (the layer axis, never
    split, taken off)."""
    return tree_map(lambda sh: NamedSharding(sh.mesh, P(*sh.spec[1:])),
                    stacked)


def _on_model(sharding, dim: int) -> bool:
    """Whether `sharding` splits tensor dim `dim` over "model"."""
    return any(d == dim and "model" in axes for d, axes in sharding.dims())


# the blocks of a layer, each known by its parameters' names (RWKV's time
# mix by its one subtree)
BLOCK_KINDS = {
    "gqa": {"wq", "wk", "wv", "wo"},
    "glu": {"gate", "up", "down"},
    "gelu": {"in", "in_b", "out", "out_b"},
    "mla": {"wq", "wkv_a", "kv_norm", "wk_b", "wv_b", "wo"},
    "mla_lora": {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b",
                 "wv_b", "wo"},
    "mamba2": {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
               "norm", "out_proj"},
    "rwkv_tm": {"tm"},
    "rwkv_cm": {"mu_k", "Wk", "Wv", "Wr"},
}

# per kind, the leaves held whole over "model" whose use inside the split
# block is a part of the work: each model rank's gradient is a part,
# summed over "model" in the gather's backward.  Never the norms before a
# block (ln1, ln2), GELU's `out_b` or the channel mix's `Wr`: they are
# used on whole values, so every rank's gradient is already whole.
PART_LEAVES = {
    "gqa": frozenset({"wk", "wv"}),
    "glu": frozenset(),
    "gelu": frozenset({"in_b"}),
    "mla": frozenset({"wkv_a", "kv_norm"}),
    "mla_lora": frozenset({"wq_a", "q_norm", "wkv_a", "kv_norm"}),
    "mamba2": frozenset({"in_proj", "conv_w", "conv_b", "A_log", "D",
                         "dt_bias", "norm"}),
    "rwkv_tm": frozenset({"mu_r", "mu_k", "mu_v", "mu_w", "mu_g",
                          "w_lora_a", "w_bias", "u", "ln_out"}),
    "rwkv_cm": frozenset({"mu_k"}),
}

# per kind, the leaves the layout splits over "model" that the split block
# takes whole: Mamba2's fused projections, whose stored column blocks fall
# across heads (`ssm.local_spans` takes the rank's columns)
WHOLE_LEAVES = {"mamba2": frozenset({"in_proj", "conv_w"})}


def block_kind(block) -> str | None:
    """The kind (`BLOCK_KINDS`) of a block's tree of parameters or of
    their shardings, or None (a norm, the MoE FFN)."""
    keys = set(block) if isinstance(block, dict) else set()
    for kind, names in BLOCK_KINDS.items():
        if keys == names:
            return kind
    return None


def _splits(cfg: ArchConfig, kind, block) -> bool:
    """Whether a block of `kind` laid out by `block` runs tensor-parallel:
    its layout splits its weights over "model", on whole heads."""
    if kind in ("glu", "gelu"):
        return _on_model(block["gate" if kind == "glu" else "in"], 1)
    if kind == "rwkv_cm":
        return _on_model(block["Wk"], 1)
    if kind == "mamba2":
        s = cfg.ssm
        w, dim = block["out_proj"], 0
        heads = s.get("expand", 2) * cfg.d_model // s["headdim"]
    elif kind == "rwkv_tm":
        w, dim, heads = block["tm"]["Wr"], 1, cfg.d_model // cfg.head_dim
    elif kind == "mla_lora":                # `wq_b`'s columns
        w, dim, heads = block["wq_b"], 1, cfg.n_heads
    else:                                   # gqa, mla: `wq`'s columns
        w, dim, heads = block["wq"], 1, cfg.n_heads
    if not _on_model(w, dim):
        return False
    if kind == "gqa":
        return attn.heads_split(cfg.n_heads, cfg.n_kv_heads, w.mesh)
    return heads % w.mesh.size("model") == 0


def split_blocks(cfg: ArchConfig, sh) -> frozenset:
    """The names of the blocks of one layer (or of zamba2's shared block),
    laid out by `sh`, that run tensor-parallel over "model": those whose
    weights the layout splits over "model", on whole heads where the
    block has heads (GQA by `attention.heads_split`; MLA, Mamba2 and
    RWKV6's time mix by a whole count of heads a rank), and the GLU / GELU
    FFNs and RWKV's channel mix on d_ff.  The layout decides; nothing is
    caught.

        >>> from repro_torch.configs import ARCHS
        >>> from repro_torch.sharding.rules import Mesh
        >>> m = Mesh.abstract((16, 16), ("data", "model"))
        >>> [sorted(split_blocks(ARCHS[a], layer_shardings(
        ...     param_shardings(ARCHS[a], m)["layers"])))
        ...  for a in ("llama3.2-3b", "rwkv6-3b", "zamba2-2.7b")]
        [['ffn'], ['ffn'], ['mixer']]
    """
    return frozenset(name for name, block in sh.items()
                     if (kind := block_kind(block)) is not None
                     and _splits(cfg, kind, block))


def _block_gather(cfg, sh, dp, keep_ffn=False):
    """(a function putting the blocks of one layer (or of zamba2's shared
    block), laid out by `sh`, together for use, the names of its
    tensor-parallel blocks).  The split blocks (`split_blocks`) keep their
    "model" split but for their `WHOLE_LEAVES`, and their `PART_LEAVES`
    sum their gradients over "model"; `keep_ffn` keeps the "model" split
    of the FFN too (an MoE layer's experts, `layers.moe_local`)."""
    split = split_blocks(cfg, sh)
    part = tuple(dp) + ("model",)

    def block(sub, bsh, kind):
        parts = PART_LEAVES[kind]
        whole = WHOLE_LEAVES.get(kind, frozenset())

        def leaf(x, s, name):
            if isinstance(x, dict):
                return {k: leaf(v, s[k], k) for k, v in x.items()}
            return gather_param(x, s, part if name in parts else dp,
                                keep=() if name in whole else ("model",))
        return leaf(sub, bsh, None)

    def gather(lp):
        out = {}
        for name, sub in lp.items():
            if name in split:
                out[name] = block(sub, sh[name], block_kind(sh[name]))
            elif keep_ffn and name == "ffn":
                out[name] = gather_params(sub, sh[name], dp, keep=("model",))
            else:
                out[name] = gather_params(sub, sh[name], dp)
        return out

    return gather, split


def _layer_gather(cfg, stacked_sh, dp, moe_layer):
    """(a function gathering one layer of a group laid out by
    `stacked_sh`, the names of the layer's tensor-parallel blocks), or
    (None, frozenset()) without a mesh (`_block_gather`; an MoE layer's
    FFN keeps its experts' "model" split for `layers.moe_local`)."""
    if stacked_sh is None:
        return None, frozenset()
    sh = layer_shardings(stacked_sh)
    moe = cfg.ffn == "moe" and moe_layer
    gate = sh["ffn"]["gate"] if moe else None
    if moe and gate.mesh.size("model") > 1 and not _on_model(gate, 2):
        raise ValueError("the experts' d_ff does not split over the "
                         "'model' axis")
    return _block_gather(cfg, sh, dp, keep_ffn=moe)


def _run_layers(cfg, layers, x, positions, *, moe_layer=False, caches=None,
                cur_len=None, mrope_positions=None, kernels: bool = False,
                offset: int = 0, remat=False, mesh=None, dp=(),
                gather=(None, frozenset()), kv_seq_shard=False):
    """Apply a stacked layer group in order (the reference's `lax.scan`).
    layers: the group's per-layer trees (`_unstack`); caches: the group's
    cache tree stacked on axis 0, layer `i` at `offset + i`, written in
    place, or None; remat: see `remat_layer` (only without caches);
    gather: `_layer_gather`'s (function putting a layer's parameter blocks
    together, inside the layer's checkpoint; the tensor-parallel blocks).

    Returns (x, aux): aux is the MoE layers' load-balance loss summed, or
    None."""
    aux = None
    names = remat == "names"
    gather, split = gather
    for i, lp in enumerate(layers):
        cache_i = None if caches is None else _index(caches, offset + i)

        def layer(x, lp=lp, cache_i=cache_i):
            if gather is not None:
                lp = gather(lp)
            return apply_layer(cfg, lp, x, positions, mesh=mesh, dp=dp,
                               moe_layer=moe_layer, cache=cache_i,
                               cur_len=cur_len,
                               mrope_positions=mrope_positions,
                               kv_seq_shard=kv_seq_shard, split=split,
                               kernels=kernels, names=names)[::2]

        x, aux_l = remat_layer(layer, remat if caches is None else False)(x)
        if aux_l is not None:
            aux = aux_l if aux is None else aux + aux_l
    return x, aux


def resolve_kernels(kernels, device: torch.device) -> bool:
    """`None` -> the CUDA kernels on the card, the plain math on the CPU.
    `True` off the card raises."""
    on_cuda = device.type == "cuda"
    if kernels is None:
        return on_cuda
    if kernels and not on_cuda:
        raise ValueError(f"kernels=True needs CUDA tensors, not {device}")
    return bool(kernels)


def split_batch(mesh, tokens, positions=None, mrope_positions=None):
    """With a mesh: (dp, this rank's rows of tokens, positions and
    M-RoPE positions (3, B, S)); without one: ((), the inputs)."""
    if mesh is None:
        return (), tokens, positions, mrope_positions
    dp = batch_axes(mesh, tokens.shape[0])
    if positions is not None:
        positions = rows(positions, mesh, dp)
    if mrope_positions is not None:
        mrope_positions = rows(mrope_positions, mesh, dp, 1)
    return dp, rows(tokens, mesh, dp), positions, mrope_positions


def decoder_forward(cfg: ArchConfig, params, tokens, *, mesh=None,
                    positions=None, mrope_positions=None, caches=None,
                    cur_len=None, kv_seq_shard=False, kernels=None,
                    remat=False):
    """tokens: (B,S) int. caches: the tree of `zoo.build_cache_specs`
    ({"layers": stacked cache tree}, plus "shared" for the hybrid stack and
    "dense_layers" for MoE) or None, written in place; cur_len: Python int
    or None; mrope_positions: (3,B,S) for M-RoPE, or None; remat: see
    `remat_layer` (training, without caches).  mesh: see the module
    docstring (the caches are then laid out by `zoo.cache_shardings`, and
    `kv_seq_shard` keeps GQA's in the split-KV layout).

    Returns (hidden: (B,S,D), caches, aux_loss): the MoE load-balance loss
    summed over layers, a float32 zero for the other models."""
    check_supported(cfg)
    dp, tokens, positions, mrope_positions = split_batch(
        mesh, tokens, positions, mrope_positions)
    sh = None if mesh is None else param_shardings(cfg, mesh)

    def whole(name):
        if sh is None:
            return params[name]
        return gather_params(params[name], sh[name], dp)

    tp = vocab_tp(cfg, mesh)
    embed = vocab_table(cfg, params, "embed", mesh, dp)
    kernels = resolve_kernels(kernels, embed.device)
    B, S = tokens.shape[:2]
    if positions is None:
        base = 0 if cur_len is None else cur_len
        positions = base + torch.arange(S, device=embed.device)[None, :]
        positions = positions.expand(B, S)
    if mrope_positions is None and cfg.rope == "mrope":
        mrope_positions = positions[None].expand(3, B, S)
    x = embed_lookup(embed, tokens, tp)
    del embed
    run = dict(cur_len=cur_len, kernels=kernels, remat=remat, mesh=mesh,
               dp=dp)
    aux = []

    def group(name):
        return None if caches is None else caches[name]

    def gather(name, moe_layer=False):
        return _layer_gather(cfg, None if sh is None else sh[name], dp,
                             moe_layer)

    if cfg.hybrid:  # zamba2: groups of mamba layers + shared attention block
        every = cfg.hybrid["attn_every"]
        layers = _unstack(params["layers"])
        shared, shared_split = params["shared_attn"], frozenset()
        if sh is not None:
            fn, shared_split = _block_gather(cfg, sh["shared_attn"], dp)
            shared = fn(shared)
        for g in range(cfg.n_layers // every):
            x, _ = _run_layers(cfg, layers[g * every:(g + 1) * every], x,
                               positions, caches=group("layers"),
                               offset=g * every, gather=gather("layers"),
                               **run)
            x, _ = apply_shared_attn(
                cfg, shared, x, positions,
                cache=None if caches is None else _index(caches["shared"], g),
                cur_len=cur_len, mesh=mesh, split=shared_split,
                kernels=kernels)
    else:
        run.update(mrope_positions=mrope_positions, kv_seq_shard=kv_seq_shard)
        if "dense_layers" in params:
            x, _ = _run_layers(cfg, _unstack(params["dense_layers"]), x,
                               positions, caches=group("dense_layers"),
                               gather=gather("dense_layers"), **run)
        moe = cfg.ffn == "moe"
        x, aux_l = _run_layers(cfg, _unstack(params["layers"]), x, positions,
                               moe_layer=moe, caches=group("layers"),
                               gather=gather("layers", moe), **run)
        if aux_l is not None:
            aux.append(aux_l)
    x = _apply_norm(cfg, whole("final_norm"), x, kernels=kernels)
    return x, caches, aux[0] if aux else x.new_zeros((), dtype=F32)


def logits_f32(x, head):
    """``x`` (..., D) against ``head`` (V, D) -> float32 (..., V):
    `layers.matmul_f32`, as the reference's `einsum(...,
    preferred_element_type=F32)`."""
    out = matmul_f32(x.reshape(-1, x.shape[-1]), head)
    return out.reshape(*x.shape[:-1], head.shape[0])


def vocab_tp(cfg: ArchConfig, mesh):
    """`mesh` when its layout splits the vocabulary (the embedding's and
    the head's rows) over "model", else None.

        >>> from repro_torch.configs import ARCHS
        >>> from repro_torch.sharding.rules import Mesh
        >>> m = Mesh.abstract((16, 16), ("data", "model"))
        >>> [vocab_tp(ARCHS[a], m) is m for a in ("llama3.2-3b",
        ...                                       "whisper-large-v3")]
        [True, False]
    """
    if mesh is None:
        return None
    sh = sharding_for(("vocab", None), (cfg.vocab, cfg.d_model), mesh)
    return mesh if _on_model(sh, 0) else None


def vocab_table(cfg: ArchConfig, params, name: str, mesh=None, dp=()):
    """The (vocab, D) table `name` ("embed" or "lm_head"), whole, or with
    a mesh this rank's vocabulary rows where `vocab_tp` splits them
    (gathered over the batch axes only)."""
    if mesh is None:
        return params[name]
    keep = ("model",) if vocab_tp(cfg, mesh) is not None else ()
    return gather_params(params[name], param_shardings(cfg, mesh)[name], dp,
                         keep=keep)


def head_of(cfg: ArchConfig, params, mesh=None, dp=()):
    """The output head (the tied embedding or `lm_head`): `vocab_table`."""
    return vocab_table(cfg, params, "embed" if cfg.tie_embeddings
                       else "lm_head", mesh, dp)


def _vocab_rows(ids, tp, n: int):
    """(this rank's row of each id, 0 for the ids outside its block; which
    ids fall in it) of a vocabulary split over "model" in blocks of n."""
    local = ids.long() - tp.index("model") * n
    ok = (local >= 0) & (local < n)
    return torch.where(ok, local, 0), ok


def embed_lookup(table, tokens, tp=None):
    """`table[tokens]`; with `tp`, `table` holds this rank's block of rows
    of a vocabulary split over "model": the ids outside it look up zeros,
    and the rows sum over "model" (each id's row comes from one rank)."""
    if tp is None:
        return table[tokens]
    idx, ok = _vocab_rows(tokens, tp, table.shape[0])
    return reduce_from(torch.where(ok[..., None], table[idx], 0), tp,
                       "model")


def lm_head(cfg: ArchConfig, params, x, *, mesh=None, dp=()):
    """float32 logits, over this rank's vocabulary rows where `vocab_tp`
    splits them (`zoo` gathers them over "model")."""
    tp = vocab_tp(cfg, mesh)
    if tp is not None:
        x = copy_to(x, tp, "model")
    return logits_f32(x, head_of(cfg, params, mesh, dp))


# ---------------------------------------------------------------------------
# chunked cross entropy
# ---------------------------------------------------------------------------

def _ce_block(x, head, labels, tp=None):
    """Summed softmax cross entropy of one sequence block, float32 logits.
    `tp`: `head` holds this rank's rows of a vocabulary split over its
    "model" ranks: the logsumexp's shift is the max over "model" (no
    gradient), its sum of exponentials and the target logit (from the
    rank holding the label) sum over "model"."""
    if tp is None:
        logits = logits_f32(x, head)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return torch.sum(lse - tgt)
    logits = logits_f32(copy_to(x, tp, "model"), head)
    m = max_over(logits.amax(dim=-1), tp, "model")
    lse = m + torch.log(reduce_from(
        torch.sum(torch.exp(logits - m[..., None]), dim=-1), tp, "model"))
    idx, ok = _vocab_rows(labels, tp, head.shape[0])
    tgt = torch.gather(logits, -1, idx[..., None])[..., 0]
    tgt = reduce_from(torch.where(ok, tgt, 0.0), tp, "model")
    return torch.sum(lse - tgt)


def chunked_ce_loss(x, embed, labels, *, block: int = 512, tp=None):
    """x: (B,S,D) final hidden; embed: (V,D) head; labels: (B,S); tp: the
    mesh whose "model" ranks split the vocabulary, `embed` this rank's
    rows (`vocab_tp`), or None.

    Mean softmax cross entropy over sequence blocks of `block` (S // block
    blocks of equal length, one block when S < block), each block under
    its own checkpoint: its float32 (B, block, V) logits live only while
    it is computed, forward and backward."""
    B, S, D = x.shape
    nb = max(S // block, 1)
    bs = S // nb
    xb = x.reshape(B, nb, bs, D)
    lb = labels.reshape(B, nb, bs)
    total = x.new_zeros((), dtype=F32)
    for i in range(nb):
        total = total + checkpoint(_ce_block, xb[:, i], embed, lb[:, i], tp,
                                   use_reentrant=False)
    return total / (B * S)
