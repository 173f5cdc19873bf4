"""Stream-planned pipeline-parallel training (a GPipe schedule over the
ranks of one mesh axis), the JAX package's `repro/train/pipeline.py` over
`torch.distributed`.

The PipelinePlan (core/planner.py) fixes the layer->stage allocation and
microbatch count; this executor materializes it: the 'pipe' mesh axis holds
one stage per rank group, activations flow stage-to-stage through
`sharding.collectives.shift` (the reference's ppermute), and autograd
differentiates straight through the pipeline: the shift's backward shifts
the gradient back a stage, as ppermute's transpose is the reversed
ppermute, so the reverse schedule emerges as it does under `jax.grad`.

Supports uniform dense decoder archs (gqa mixers with glu/gelu ffn).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.module import tree_map
from repro_torch.sharding.collectives import copy_to, reduce_from, shift

F32 = torch.float32


def stage_stacked_specs(cfg: ArchConfig, n_stages: int):
    """Param specs with layers grouped (n_stages, L/stage, ...), stage axis
    sharded along 'pipe' (and the layer axis within a stage unsplit: the
    reference writes one axis name too few there and its ParamSpec
    refuses the spec; ROADMAP §3)."""
    from repro_torch.models.zoo import build_param_specs
    specs = build_param_specs(cfg)
    per = cfg.n_layers // n_stages

    def regroup(s):
        rest = s.axes[1:] if s.axes else (None,) * (len(s.shape) - 1)
        return dataclasses.replace(s, shape=(n_stages, per) + s.shape[1:],
                                   axes=("pipe", None) + rest)

    specs["layers"] = tree_map(regroup, specs["layers"])
    return specs


def make_pipeline_loss(cfg: ArchConfig, mesh, *, n_stages: int,
                       n_microbatches: int, axis: str = "pipe",
                       remat=False):
    """Returns loss(params, batch) with pipeline parallelism over `axis`.
    remat (a port keyword; the reference keeps every activation): each
    layer under `transformer.remat_layer`, the same function in less
    memory.

    params['layers'] leaves: this rank's block (1, L/stage, ...) of the
    (n_stages, L/stage, ...) stack split on `axis`; embed / final_norm /
    lm_head whole on every rank.
    batch: tokens (B, S), labels (B, S), the same on every rank;
    B % n_microbatches == 0.  Every rank returns the loss.
    """
    if mesh.size(axis) != n_stages:
        raise ValueError(f"{n_stages} stages over {mesh.size(axis)} "
                         f"{axis!r} ranks")

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        mb = B // n_microbatches
        tok_mb = tokens.reshape(n_microbatches, mb, S)
        lab_mb = labels.reshape(n_microbatches, mb, S)
        stage = mesh.index(axis)
        # whole parameters feed one stage's work each: their gradients
        # sum over the stages
        embed = copy_to(params["embed"], mesh, axis)
        final_norm_scale = copy_to(params["final_norm"]["scale"], mesh, axis)
        head = embed if cfg.tie_embeddings else \
            copy_to(params["lm_head"], mesh, axis)
        layers = tfm._unstack(tree_map(lambda a: a[0], params["layers"]))
        positions = torch.arange(S, device=tokens.device)[None, :].expand(
            mb, S)

        def layer(x, lp):
            return tfm.apply_layer(cfg, lp, x, positions, mesh=None)[0]

        layer = tfm.remat_layer(layer, remat)

        def block_stack(x):
            for lp in layers:
                x = layer(x, lp)
            return x

        n_steps = n_microbatches + n_stages - 1
        x_prev = torch.zeros((mb, S, cfg.d_model), dtype=cfg.dtype,
                             device=tokens.device)
        loss_acc = torch.zeros((1,), dtype=F32, device=tokens.device)
        # every stage takes in the embedding and runs the loss at every
        # step, masking what is not its own (the reference's
        # `jnp.where`s), so that every rank's backward reaches every
        # whole parameter's `copy_to` and runs the same collectives; the
        # layers run only on the steps a stage is active (an inactive
        # step's output is its input, as the reference selects it)
        flag = functools.partial(torch.tensor, device=tokens.device)
        for t in range(n_steps):
            # receive activation from the previous stage
            x_in = shift(x_prev, mesh, axis)
            # stage 0 injects microbatch t (if in range)
            m_idx = min(max(t, 0), n_microbatches - 1)
            fresh = embed[tok_mb[m_idx]].to(cfg.dtype)
            x = torch.where(flag(stage == 0), fresh, x_in)
            active = 0 <= t - stage < n_microbatches
            y = block_stack(x) if active else x
            # last stage computes the loss for its finished microbatch
            m_done = min(max(t - (n_stages - 1), 0), n_microbatches - 1)
            h = tfm.rmsnorm(y, final_norm_scale) if cfg.norm == "rms" else y
            l = tfm.chunked_ce_loss(h, head, lab_mb[m_done],
                                    block=min(512, S))
            use = stage == n_stages - 1 and t - (n_stages - 1) >= 0
            loss_acc = loss_acc + torch.where(flag(use), l, 0.0)
            x_prev = y
        # only the last stage holds a nonzero loss: the sum over stages is
        # every rank's loss
        return reduce_from(loss_acc, mesh, axis).sum() / n_microbatches

    return loss_fn
