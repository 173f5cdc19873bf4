"""Training step factory, from the JAX package's `repro/train/train_step.py`:
loss -> grads -> (optional int8 error-feedback gradient compression) ->
AdamW, with microbatched gradient accumulation.

Gradients come from `torch.autograd.grad` over the parameter leaves (the
parameter tree stays a plain nested dict of tensors, as the models take
it); the microbatches run one after another, their float32 gradients
summed, as the reference's `lax.scan`.  The update is in place
(`optimizer.adamw_update`): the step returns the same parameter and
moment tensors, overwritten.  Gradient compression quantizes each
gradient to int8 with a per-tensor scale and carries the quantization
error to the next step (error feedback, `ef`, also updated in place), the
numerics of a compressed all-reduce.

With a `mesh` (`sharding.rules.Mesh`), parameters and the optimizer state
are this rank's blocks by `transformer.param_shardings` (FSDP / ZeRO-3),
the batch is the global batch on every rank, and `zoo.train_loss` splits
its rows over the data-parallel ranks, gathers each layer's weights over
them before use and sums the gradients over those ranks in the gathers'
backward (`sharding.collectives`).  The blocks split over "model"
(`transformer.split_blocks`, the vocabulary by `transformer.vocab_tp`)
run tensor-parallel: a split leaf's gradient is this rank's block; a leaf
held whole over "model" that feeds the split work
(`transformer.PART_LEAVES`: `wk` and `wv`, whose K/V feed only this
rank's heads; GELU's `in_b`, sliced to its d_ff; MLA's `wkv_a` and
`kv_norm`; Mamba2's `in_proj`, `conv_w` and per-head leaves; RWKV's token
mixes, `w_lora_a`, `u`, `w_bias` and `ln_out`) gets a part on each model
rank, summed over "model" in its gather's backward; a leaf used on the
replicated side of the split (`out_b` after the sum, the channel mix's
`Wr`, the norms before a block) already has its whole gradient, the same
on every model rank.
So every leaf's gradient blocks are those of the reference's gradient,
and the clipping norm and the int8 scales are taken over whole leaves,
each block once (`optimizer.split_sum` over the axes a leaf splits over).

While a `torch.profiler` records, a step marks its phases on the device
channel (`repro_torch.obs.realtime.device_tracer`): `train.forward` (the
loss), `train.backward` (`torch.autograd.grad`, a microbatch each) and
`train.optimizer` (`adamw_update`), each with the step's sequence number.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed import ReduceOp

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models import zoo
from repro_torch.models.module import (ParamSpec, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.obs.realtime import device_tracer
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state, opt_state_specs,
                                         split_sum)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    remat: bool | str = True
    grad_compress: bool = False    # int8 + error feedback
    opt: AdamWConfig = AdamWConfig()


def _quantize_int8(g, sharding=None):
    amax = split_sum(torch.max(torch.abs(g)), sharding, ReduceOp.MAX)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads(grads, ef, shardings=None):
    """int8 error-feedback compression: returns (decompressed grads, new
    ef).  The new error is written into `ef` in place (the returned `ef`
    is the one given), as the optimizer updates its moments.
    `torch.round` rounds half to even, as `jnp.round` does.  `shardings`:
    each leaf's scale is taken over the whole leaf from its blocks."""
    def one(g, e, sh):
        gf = e.add_(g.to(F32))            # g + e, where e was
        q, scale = _quantize_int8(gf, sh)
        deq = q.to(F32) * scale
        gf.sub_(deq)                      # the carried error g + e - deq
        return deq.to(g.dtype)

    leaves = tree_leaves(grads)
    shs = [None] * len(leaves) if shardings is None else \
        tree_leaves(shardings)
    out = [one(g, e, sh) for g, e, sh in zip(leaves, tree_leaves(ef), shs)]
    return tree_unflatten(grads, out), ef


def init_train_state(cfg: ArchConfig, params, step_cfg: TrainStepConfig):
    state = init_opt_state(params)
    if step_cfg.grad_compress:
        state["ef"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
    return state


def train_state_specs(param_specs, step_cfg: TrainStepConfig):
    specs = opt_state_specs(param_specs)
    if step_cfg.grad_compress:
        specs["ef"] = tree_map(
            lambda s: ParamSpec(s.shape, F32, s.axes, init="zeros"),
            param_specs)
    return specs


def _split_batch(batch: dict, mb: int) -> list[dict]:
    """The global batch as `mb` microbatches on axis 0 (mrope_positions
    (3, B, S) on axis 1); a tensor whose axis 0 does not divide goes whole
    to every microbatch, as the reference broadcasts it."""
    out = [{} for _ in range(mb)]
    for k, v in batch.items():
        if k == "mrope_positions":
            parts = v.reshape(v.shape[0], mb, -1, v.shape[2]).unbind(1)
        elif v.ndim >= 1 and v.shape[0] % mb == 0:
            parts = v.reshape((mb, v.shape[0] // mb) + v.shape[1:]).unbind(0)
        else:
            parts = [v] * mb
        for o, part in zip(out, parts):
            o[k] = part
    return out


def make_train_step(cfg: ArchConfig, mesh, step_cfg: TrainStepConfig):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics); params and the moments are updated in place.  mesh: None
    (one device) or a `sharding.rules.Mesh` (module docstring)."""
    shardings = None if mesh is None else tfm.param_shardings(cfg, mesh)
    step = 0                    # steps so far: the spans' identifier

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tr = device_tracer()
        with torch.enable_grad():
            with tr.span("train.forward", step=step):
                loss = zoo.train_loss(cfg, tree_unflatten(params, leaves),
                                      batch, mesh=mesh, remat=step_cfg.remat)
            with tr.span("train.backward", step=step):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
        return loss.detach(), tree_unflatten(params, list(grads))

    def grads_of(params, batch):
        mb = step_cfg.microbatches
        if mb <= 1:
            return value_and_grad(params, batch)
        loss_acc = None
        g_acc = None
        for mb_batch in _split_batch(batch, mb):
            loss, grads = value_and_grad(params, mb_batch)
            loss_acc = loss if loss_acc is None else loss_acc + loss
            if g_acc is None:
                g_acc = tree_map(lambda g: g.to(F32), grads)
            else:
                for a, g in zip(tree_leaves(g_acc), tree_leaves(grads)):
                    a.add_(g.to(F32))
            del grads
        grads = tree_map(lambda g: (g / mb).to(cfg.dtype), g_acc)
        return loss_acc / mb, grads

    def train_step(params, opt_state, batch):
        nonlocal step
        step += 1
        loss, grads = grads_of(params, batch)
        if step_cfg.grad_compress:
            grads, new_ef = compress_grads(grads, opt_state["ef"], shardings)
        state = {k: v for k, v in opt_state.items() if k != "ef"}
        del opt_state
        with device_tracer().span("train.optimizer", step=step):
            new_params, new_state, metrics = adamw_update(
                step_cfg.opt, params, grads, state, shardings=shardings)
        if step_cfg.grad_compress:
            new_state["ef"] = new_ef
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return train_step
