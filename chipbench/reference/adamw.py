"""Plain AdamW with global-norm clipping and a warm-up then cosine learning
rate, in float32, for the training cells' reference.

The hyper-parameters are the training traffic file's (`optimizer`).  A
leaf of two or more dimensions as stored (every stacked per-layer leaf
too) takes weight decay.  The new parameters are stored in each leaf's
configured type: `round_to` rounds a bfloat16 leaf's float32 value to
bfloat16 after every update, as the served parameters are kept.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def learning_rate(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"]) /
                   max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_ratio"] +
                               (1 - opt["min_lr_ratio"]) * cos)


class AdamW:
    def __init__(self, opt: dict, params: list, dtypes: list):
        self.opt = opt
        self.dtypes = dtypes
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.step_count = 0

    @torch.no_grad()
    def step(self, params: list, grads: list, each=None) -> list:
        """Update `params` (float32 leaves) in place; returns the clipped
        gradients' per-leaf norms.  `each(i, g)` sees leaf i's clipped
        gradient."""
        o = self.opt
        self.step_count += 1
        t = self.step_count
        norm = math.sqrt(sum(float(torch.sum(g.float() ** 2))
                             for g in grads))
        scale = min(o["clip_norm"] / max(norm, 1e-9), 1.0)
        lr = learning_rate(o, t)
        b1c, b2c = 1 - o["b1"] ** t, 1 - o["b2"] ** t
        norms = []
        for p, g, m, v, dt in zip(params, grads, self.m, self.v,
                                  self.dtypes):
            g = g.float() * scale
            norms.append(float(torch.linalg.vector_norm(g)))
            if each is not None:
                each(len(norms) - 1, g)
            m.mul_(o["b1"]).add_((1 - o["b1"]) * g)
            v.mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + o["eps"])
            if p.ndim >= 2:
                upd.add_(o["weight_decay"] * p)
            p.sub_(lr * upd)
            if dt != F32:
                p.copy_(p.to(dt).float())
        return norms
