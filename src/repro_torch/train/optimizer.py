"""AdamW with global-norm clipping and a cosine schedule, from the JAX
package's `repro/train/optimizer.py`.

The schedule, the bias corrections and the clip scale are float32 tensors
on the parameters' device, as the reference computes them on its device
(Python floats would round `lr` differently in the last bits).  Leaves are
visited in sorted-key order (`models.module.tree_leaves`, as
`jax.tree.leaves` visits dicts), so the norm sums them in the reference's
order.  The update runs in place under `torch.no_grad()`: parameters, `m`
and `v` are overwritten with the values the reference returns as new
arrays, which a full-width state needs (parameters, gradients and two
float32 moments of llama3.2-3b hold 38 GB).

`shardings` (a tree of `sharding.rules.NamedSharding`, for parameters
held as this rank's blocks over a mesh) makes the clipping norm global:
each leaf's sum of squares is summed over the ranks its blocks split
over.  The update itself is elementwise, so each rank updates its blocks.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.module import ParamSpec, tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at `step` (an integer tensor) as a float32 tensor."""
    step = step.to(F32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params) -> dict:
    """Float32 zero moments shaped as `params`, and an int32 step of 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_specs(param_specs):
    """ParamSpec tree for the optimizer state (same layout as params)."""
    def f32spec(s):
        return ParamSpec(s.shape, F32, s.axes, init="zeros")

    return {"m": tree_map(f32spec, param_specs),
            "v": tree_map(f32spec, param_specs),
            "step": ParamSpec((), torch.int32, None, init="zeros")}


def split_sum(x: torch.Tensor, sharding=None, op=None) -> torch.Tensor:
    """`x`, a reduction over one rank's block, reduced (SUM, or `op`) over
    the ranks the leaf's blocks split over (`x` itself without
    `sharding`)."""
    if sharding is None:
        return x
    from torch.distributed import ReduceOp

    from repro_torch.sharding.collectives import all_reduce
    axes = tuple(a for _, ax in sharding.dims() for a in ax)
    return all_reduce(x, sharding.mesh, axes, op or ReduceOp.SUM)


def global_norm(tree, shardings=None) -> torch.Tensor:
    leaves = tree_leaves(tree)
    shs = [None] * len(leaves) if shardings is None else \
        tree_leaves(shardings)
    return torch.sqrt(sum(split_sum(torch.sum(torch.square(x.to(F32))), sh)
                          for x, sh in zip(leaves, shs)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, *, shardings=None):
    """One AdamW step, in place: `params`, `state["m"]` and `state["v"]`
    are overwritten. Returns (params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, shardings)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(F32))
    b2c = 1 - torch.pow(cfg.b2, step.to(F32))

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.to(F32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.to(F32)
        if p.ndim >= 2:
            upd.add_(cfg.weight_decay * pf)
        p.copy_(pf - lr * upd)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
