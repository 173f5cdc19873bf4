"""Model zoo: ArchConfig -> param/cache specs + prefill / decode entry points
+ analytic MODEL_FLOPS, from the JAX package's `repro/models/zoo.py`.

`prefill` and `decode_step` take `kernels`: `None` runs the hand-written
CUDA kernels (rmsnorm, flash attention, decode attention, the SSD and WKV
scans, the expert GEMM) when the weights lie on the card and the plain model
math on the CPU; `True` off the card raises; `False` runs the plain math on
the card too, to compare the two.  All ten configs run: the decoders
through `transformer.decoder_forward` (M-RoPE positions from
`batch["mrope_positions"]` at prefill, text positions otherwise) and whisper
through `encdec` (`batch["enc_embeds"]` at prefill; `decode_step` takes
`enc_out`, which its cached path does not read, as in the reference).
Caches are written in place.

`train_loss` is the training objective (chunked cross entropy, plus
0.01 x the MoE load-balance loss), run through the plain layers on every
device, as the reference's runs no Pallas kernel: the CUDA kernels have no
backward.  `input_specs` gives each cell's data arguments as meta tensors
(shapes and dtypes, no storage).

`mesh` (`sharding.rules.Mesh`): the batch (whole on every rank) splits
over the data-parallel axes, the parameters are this rank's blocks
(`transformer.param_shardings`), the dense blocks the layout splits over
"model" run tensor-parallel (`transformer.split_blocks`: attention, MLA,
Mamba2 and RWKV6 on whole heads, the FFNs and RWKV's channel mix on d_ff),
the caches are this rank's blocks by `cache_shardings` (a split mixer
reads and writes only its heads of them), and the logits (or the loss) come
back whole on every rank: the last-token logits of a vocabulary split over
"model" gathered over it (`collectives.gather_from`), the loss through the
vocab-parallel cross entropy.  `decode_step(kv_seq_shard=True)` runs GQA's decode attention
split-KV over the "data" ranks (`layers.decode_attention_kv_sharded`),
on caches laid out so by `cache_shardings(..., kv_seq_shard=True)` and
filled by `prefill(..., kv_seq_shard=True)`; without a mesh it is the
plain decode, as in the reference.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels import mla_attention as mla_kernel
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.module import ParamSpec, count_params, stack_specs
from repro_torch.models.ssm import CONV_W
from repro_torch.obs.realtime import device_tracer
from repro_torch.sharding.collectives import gather_from, mean_over, rows
from repro_torch.sharding.rules import (DEFAULT_RULES, all_gather,
                                        batch_axes, tree_shardings)

F32 = torch.float32


# ---------------------------------------------------------------------------
# parameter / cache specs
# ---------------------------------------------------------------------------

def build_param_specs(cfg: ArchConfig):
    if cfg.family == "encdec":
        return encdec.whisper_param_specs(cfg)
    specs: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), cfg.dtype,
                           ("vocab", None), scale=0.02),
        "final_norm": tfm._norm_specs(cfg),
    }
    if cfg.mixer == "rwkv6":
        specs["layers"] = stack_specs(tfm.rwkv_layer_specs(cfg), cfg.n_layers)
    elif cfg.hybrid:
        specs["layers"] = stack_specs(tfm.layer_specs(cfg), cfg.n_layers)
        specs["shared_attn"] = tfm.shared_attn_specs(cfg)
    elif cfg.ffn == "moe":
        n_dense = cfg.moe.get("first_dense_layers", 0)
        if n_dense:
            specs["dense_layers"] = stack_specs(
                tfm.layer_specs(cfg, moe_layer=False), n_dense)
        specs["layers"] = stack_specs(
            tfm.layer_specs(cfg, moe_layer=True), cfg.n_layers - n_dense)
    else:
        specs["layers"] = stack_specs(tfm.layer_specs(cfg), cfg.n_layers)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.vocab, cfg.d_model), cfg.dtype,
                                     ("vocab", None), scale=0.02)
    return specs


def _mixer_cache_specs(cfg: ArchConfig, batch: int, max_len: int):
    if cfg.mixer == "gqa":
        return attn.gqa_cache_specs(cfg, batch, max_len, cfg.dtype)
    if cfg.mixer == "mla":
        return attn.mla_cache_specs(cfg, batch, max_len, cfg.dtype)
    if cfg.mixer == "rwkv6":
        H = cfg.d_model // cfg.head_dim
        return {
            "state": ParamSpec((batch, H, cfg.head_dim, cfg.head_dim), F32,
                               ("batch", "heads", None, None), init="zeros"),
            "last_tm": ParamSpec((batch, cfg.d_model), cfg.dtype,
                                 ("batch", None), init="zeros"),
            "last_cm": ParamSpec((batch, cfg.d_model), cfg.dtype,
                                 ("batch", None), init="zeros"),
        }
    if cfg.mixer == "mamba2":
        s = cfg.ssm
        d_inner = s.get("expand", 2) * cfg.d_model
        H = d_inner // s["headdim"]
        d_conv = d_inner + 2 * s["d_state"]
        return {
            "state": ParamSpec((batch, H, s["headdim"], s["d_state"]), F32,
                               ("batch", "heads", None, None), init="zeros"),
            "conv": ParamSpec((batch, CONV_W - 1, d_conv), cfg.dtype,
                              ("batch", None, None), init="zeros"),
        }
    raise ValueError(cfg.mixer)


def build_cache_specs(cfg: ArchConfig, batch: int, max_len: int):
    """Per-layer caches stacked over layers: KV for attention, the float32
    state and the token-shift / conv carry for RWKV6 and Mamba2; the hybrid
    stack adds one KV cache per shared-attention application ("shared"),
    and MoE splits off its dense first layers ("dense_layers"); MLA caches
    the latent and the rope key; whisper its self and cross K/V."""
    tfm.check_supported(cfg)
    if cfg.family == "encdec":
        return encdec.whisper_cache_specs(cfg, batch, max_len)
    per_layer = _mixer_cache_specs(cfg, batch, max_len)
    if cfg.hybrid:
        n_groups = cfg.n_layers // cfg.hybrid["attn_every"]
        kv = attn.gqa_cache_specs(cfg, batch, max_len, cfg.dtype)
        return {"layers": stack_specs(per_layer, cfg.n_layers),
                "shared": stack_specs(kv, n_groups)}
    n_dense = cfg.moe.get("first_dense_layers", 0) if cfg.ffn == "moe" else 0
    out = {"layers": stack_specs(per_layer, cfg.n_layers - n_dense)}
    if n_dense:
        out["dense_layers"] = stack_specs(per_layer, n_dense)
    return out


def cache_shardings(cfg: ArchConfig, batch: int, max_len: int, mesh,
                    kv_seq_shard: bool = False):
    """The layout of the caches a call with `mesh` takes: every leaf's
    batch dim split over the data-parallel axes (as the activations are),
    the rest whole; with `kv_seq_shard`, GQA's K/V caches of the decoder
    stack hold every row instead and their sequence split over "data"
    (`attention.KV_AXIS`), which must divide `max_len`."""
    specs = build_cache_specs(cfg, batch, max_len)
    sh = tree_shardings(specs, mesh, rules={"batch": DEFAULT_RULES["batch"]})
    if kv_seq_shard and cfg.mixer == "gqa" and not cfg.hybrid:
        n = mesh.size(attn.KV_AXIS)
        if max_len % n:
            raise ValueError(f"max_len {max_len} does not split over {n} "
                             f"{attn.KV_AXIS} ranks")
        for g in ("layers", "dense_layers"):
            if g in specs:
                sh[g] = tree_shardings(specs[g], mesh,
                                       rules={"kv_seq": attn.KV_AXIS})
    return sh


def kernel_launches(cfg: ArchConfig, mesh=None) -> tuple[dict, dict]:
    """Each CUDA kernel's launches in one prefill and in one decode step of
    `cfg` on the kernel path (kernels absent from a dict launch 0 times),
    on one rank of `mesh`: where Mamba2 or RWKV6's time mix runs
    tensor-parallel, its norm over the split row (the gated norm,
    `ln_out`) is `layers.rmsnorm_split`'s plain math, by design, and
    launches no `rmsnorm`.

        >>> from repro_torch.configs import ARCHS
        >>> from repro_torch.sharding.rules import Mesh
        >>> m = Mesh.abstract((1, 2), ("data", "model"))
        >>> [kernel_launches(ARCHS["rwkv6-3b"], x)[0]["rmsnorm"]
        ...  for x in (None, m)]
        [97, 65]
    """
    n = cfg.n_layers
    split_norms = 0
    if mesh is not None and cfg.mixer in ("mamba2", "rwkv6"):
        sh = tfm.layer_shardings(tfm.param_shardings(cfg, mesh)["layers"])
        split_norms = n if "mixer" in tfm.split_blocks(cfg, sh) else 0
    if cfg.family == "encdec":      # layernorm; encoder, self, cross
        flash = cfg.enc["enc_layers"] + 2 * n
        return ({"flash_attention": flash},
                {"decode_attention": n, "flash_attention": n})
    if cfg.hybrid:                  # Mamba2 layers + the shared block
        g = n // cfg.hybrid["attn_every"]
        norms = 2 * n + 2 * g + 1 - split_norms  # ln1, gated; ln1, ln2
        return ({"rmsnorm": norms, "flash_attention": g, "ssd_scan": n},
                {"rmsnorm": norms, "decode_attention": g})
    if cfg.mixer == "rwkv6":        # ln1, ln_out, ln2
        norms = 3 * n + 1 - split_norms
        return ({"rmsnorm": norms, "rwkv6_scan": n}, {"rmsnorm": norms})
    moe = 3 * (n - cfg.moe["first_dense_layers"]) if cfg.ffn == "moe" else 0
    if cfg.mixer == "mla":          # ln1, kv_norm[, q_norm], ln2
        norms = (4 if cfg.mla.get("q_lora") else 3) * n + 1
        m = cfg.mla                     # the prefill attention's kernel
        widths = (m["qk_nope"], m["qk_rope"], m["v_dim"])
        mla = n if cfg.dtype == torch.bfloat16 and \
            widths in mla_kernel.WIDTHS else 0
        return ({"rmsnorm": norms, "moe_gemm": moe, "mla_attention": mla},
                {"rmsnorm": norms, "moe_gemm": moe})
    return ({"rmsnorm": 2 * n + 1, "flash_attention": n, "moe_gemm": moe},
            {"rmsnorm": 2 * n + 1, "decode_attention": n, "moe_gemm": moe})


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _dp(mesh, batch: int):
    return batch_axes(mesh, batch) if mesh is not None else ()


def _whole_rows(x, mesh, dp):
    return x if mesh is None else all_gather(x, mesh, dp, 0)


def _logits(cfg, params, x, mesh, dp):
    """float32 logits (B, V) of the last hidden rows `x`, whole on every
    rank: this rank's vocabulary gathered over "model", its rows over
    `dp` (the device channel's `model.head` span)."""
    with device_tracer().span("model.head"):
        logits = tfm.lm_head(cfg, params, x, mesh=mesh, dp=dp)
        if tfm.vocab_tp(cfg, mesh) is not None:
            logits = gather_from(logits, mesh, "model", -1)
        return _whole_rows(logits, mesh, dp)


def _ce(cfg, params, x, labels, mesh, dp):
    with device_tracer().span("model.head"):
        return tfm.chunked_ce_loss(x, tfm.head_of(cfg, params, mesh, dp),
                                   labels, tp=tfm.vocab_tp(cfg, mesh))


def train_loss(cfg: ArchConfig, params, batch, *, mesh=None, remat=True):
    """batch: tokens (B,S), labels (B,S) [+ enc_embeds (B,Te,D) for
    whisper, mrope_positions (3,B,S) for M-RoPE].

    Returns the scalar float32 loss (CE + 0.01 x MoE aux), through the
    plain layers (`kernels=False`); remat: `transformer.remat_layer`.
    With a mesh, each rank's CE over its rows is averaged over the
    data-parallel ranks (`collectives.mean_over`), and every rank holds
    the loss."""
    dp = _dp(mesh, batch["tokens"].shape[0])
    labels = batch["labels"] if mesh is None else \
        rows(batch["labels"], mesh, dp)
    if cfg.family == "encdec":
        enc_out = encdec.encode(cfg, params, batch["enc_embeds"], mesh=mesh,
                                kernels=False, remat=remat)
        x, _ = encdec.decode_stack(cfg, params, batch["tokens"], enc_out,
                                   mesh=mesh, kernels=False, remat=remat)
        loss = _ce(cfg, params, x, labels, mesh, dp)
        return loss if mesh is None else mean_over(loss, mesh, dp)
    x, _, aux = tfm.decoder_forward(
        cfg, params, batch["tokens"], mesh=mesh,
        mrope_positions=batch.get("mrope_positions"), kernels=False,
        remat=remat)
    loss = _ce(cfg, params, x, labels, mesh, dp)
    if mesh is not None:
        loss = mean_over(loss, mesh, dp)
    if cfg.ffn == "moe":
        loss = loss + 0.01 * aux
    return loss


def prefill(cfg: ArchConfig, params, batch, caches, *, mesh=None,
            kv_seq_shard=False, kernels=None):
    """Run the prompt, fill caches in place, return last-token float32
    logits (B, V) + caches.  batch: tokens (B,S) [+ enc_embeds (B,Te,D) for
    whisper, mrope_positions (3,B,S) for M-RoPE].  kv_seq_shard (a port
    keyword): the caches are in the split-KV layout (`cache_shardings`)."""
    dp = _dp(mesh, batch["tokens"].shape[0])
    if cfg.family == "encdec":
        enc_out = encdec.encode(cfg, params, batch["enc_embeds"], mesh=mesh,
                                kernels=kernels)
        x, caches = encdec.decode_stack(cfg, params, batch["tokens"], enc_out,
                                        mesh=mesh, caches=caches, cur_len=0,
                                        kernels=kernels)
        return _logits(cfg, params, x[:, -1], mesh, dp), caches
    x, caches, _ = tfm.decoder_forward(
        cfg, params, batch["tokens"], mesh=mesh, caches=caches, cur_len=0,
        mrope_positions=batch.get("mrope_positions"),
        kv_seq_shard=kv_seq_shard, kernels=kernels)
    return _logits(cfg, params, x[:, -1], mesh, dp), caches


def decode_step(cfg: ArchConfig, params, tokens, caches, cur_len: int, *,
                mesh=None, kv_seq_shard=False, enc_out=None, kernels=None):
    """One decode step. tokens: (B,1); cur_len: Python int, the number of
    positions already in the cache; enc_out: whisper's encoder output (as
    `encdec.encode` returns it: this rank's rows with a mesh).

    Returns (float32 logits (B,V), caches written in place)."""
    dp = _dp(mesh, tokens.shape[0])
    if cfg.family == "encdec":
        x, caches = encdec.decode_stack(cfg, params, tokens, enc_out,
                                        mesh=mesh, caches=caches,
                                        cur_len=cur_len, kernels=kernels)
        return _logits(cfg, params, x[:, -1], mesh, dp), caches
    x, caches, _ = tfm.decoder_forward(cfg, params, tokens, mesh=mesh,
                                       caches=caches, cur_len=cur_len,
                                       kv_seq_shard=kv_seq_shard,
                                       kernels=kernels)
    return _logits(cfg, params, x[:, -1], mesh, dp), caches


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no storage) + analytic FLOPs
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The data arguments of one (arch x shape) cell as meta tensors, with
    the shapes and dtypes of the reference's `ShapeDtypeStruct`s."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(shape_, dtype=i32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": spec((B, S))}
        if shape.kind == "train":
            batch["labels"] = spec((B, S))
        if cfg.family == "encdec":
            batch["enc_embeds"] = spec((B, cfg.enc["enc_len"], cfg.d_model),
                                       cfg.dtype)
        if cfg.rope == "mrope":
            batch["mrope_positions"] = spec((3, B, S))
        return batch
    # decode: one new token against a cache of length S
    batch = {"tokens": spec((B, 1)), "cur_len": spec(())}
    if cfg.family == "encdec":
        batch["enc_out"] = spec((B, cfg.enc["enc_len"], cfg.d_model),
                                cfg.dtype)
    return batch


def active_params(cfg: ArchConfig) -> int:
    """Active parameters per token (MoE counts shared + top_k routed)."""
    total = count_params(build_param_specs(cfg))
    if cfg.ffn != "moe":
        return total
    m = cfg.moe
    n_moe_layers = cfg.n_layers - m.get("first_dense_layers", 0)
    per_expert = 3 * cfg.d_model * m["d_ff_expert"]
    inactive = n_moe_layers * (m["n_routed"] - m["top_k"]) * per_expert
    return total - inactive


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D (train) / 2*N_active*D (+attention
    KV term) for inference shapes."""
    n_act = active_params(cfg)
    n_emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n_body = n_act - n_emb + cfg.vocab * cfg.d_model  # head matmul is compute
    B, S = shape.global_batch, shape.seq_len
    if cfg.mixer in ("gqa", "mla"):
        attn_tr = 2 * B * S * S * cfg.n_heads * cfg.head_dim  # causal avg
        attn_dec = 4 * B * S * cfg.n_heads * cfg.head_dim
    else:
        attn_tr = attn_dec = 0.0
    if shape.kind == "train":
        return 6.0 * n_body * B * S + 3.0 * attn_tr
    if shape.kind == "prefill":
        return 2.0 * n_body * B * S + attn_tr
    return 2.0 * n_body * B + attn_dec
