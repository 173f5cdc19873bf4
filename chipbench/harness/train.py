"""The training cells: the program's training step driven over token
batches made on the device from the seed, and its first steps held
against the plain reference.

Set-up builds one step object (`make_train_step(cfg, None, config)`, with
the traffic file's optimizer settings), its parameters and optimizer
state, and drives it through the first `check_steps` steps on fresh rows;
the window goes on with that same object.  Of those first steps the run
keeps each step's loss, the first clipped gradient as the optimizer holds
it (its first moment over 1 - b1; a copy on the host, and each leaf's
norm), and each leaf's norm of the parameters' change over those steps,
read before the window moves them again.

The reference makes the same weights and batches again once the program
has been freed, and follows the same steps in float32: loss, autograd,
`reference.adamw`.  `compare` gives the numbers the limits files name:
`grad_error`, the first clipped gradient's distance from
the reference's over the whole model (first order in the rounding), and
`change_gap`, by the worst leaf the gap between the norms of the
parameters' change.  A leaf whose reference gradient is under a
thousandth of the median leaf's moves by round-off alone and is left out
of the change.
"""
from __future__ import annotations

import math
import time

import torch

from harness import spec
from harness.stats import median
from harness.device import free, peak_bytes, start_profiler, sync
from harness.weights import generator, model_weights, tensors

clock = time.perf_counter
QUIET = 1e-3            # a leaf's gradient below this share of the median's


class Feed:
    """Token batches (B, S) and their next-token labels, from the seed."""

    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        self.B, self.S = traffic["batch"], traffic["seq"]
        self.vocab, self.device = vocab, device
        self.gen = generator(seed, 2, device)

    def batch(self) -> dict:
        t = torch.randint(0, self.vocab, (self.B, self.S + 1),
                          generator=self.gen, device=self.device)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def optimizer_config(traffic: dict):
    from repro_torch.train.optimizer import AdamWConfig
    return AdamWConfig(**traffic["optimizer"])


def change_norms(params, config: dict, device) -> list:
    """Each leaf's norm of its change from the configuration's weights."""
    start = model_weights(config, device)
    out = [float(torch.linalg.vector_norm(p.float() - q.float()))
           for p, q in zip(tensors(params), tensors(start))]
    del start
    return out


class Program:
    def __init__(self, cell, seed: int, device, traced: bool, mesh=None):
        if mesh is not None or cell.config.get("mesh"):
            raise ValueError(
                f"{cell.name}: training over several cards is not measured; "
                "a training cell's configuration has no mesh")
        from repro_torch.train.train_step import (TrainStepConfig,
                                                  init_train_state,
                                                  make_train_step)
        self.cell, self.seed, self.device, self.traced = cell, seed, device, \
            traced
        tr = cell.traffic
        arch = spec.arch_config(cell.config)
        step_cfg = TrainStepConfig(opt=optimizer_config(tr))
        self.params = model_weights(cell.config, device)
        self.state = init_train_state(arch, self.params, step_cfg)
        self.step = make_train_step(arch, None, step_cfg)
        self.feed = Feed(tr, arch.vocab, seed, device)
        self.losses, self.grad_norms = [], []
        b1 = step_cfg.opt.b1
        for i in range(tr["check_steps"]):
            self.params, self.state, m = self.step(self.params, self.state,
                                                   self.feed.batch())
            self.losses.append(float(m["loss"]))
            if i == 0:
                first = [x / (1 - b1) for x in tensors(self.state["m"])]
                self.grad_norms = [float(torch.linalg.vector_norm(g))
                                   for g in first]
                self.first_grad = [g.to("cpu") for g in first]
                del first
        self.change_norms = change_norms(self.params, cell.config, device)
        sync(device)

    def window(self, seconds: float, t_start: float):
        """Steps until `seconds` have passed (each synchronised); a traced
        run profiles steps `trace_from` .. `trace_from + trace_steps - 1`."""
        from harness.record import Run
        from harness.trace import WINDOW, Trace
        tr = self.cell.traffic
        steps, trace = [], None
        t0 = clock()
        setup_s = t0 - t_start
        while clock() - t0 < seconds or (self.traced and trace is None):
            i = len(steps)
            profiled = self.traced and \
                tr["trace_from"] <= i < tr["trace_from"] + tr["trace_steps"]
            if profiled and i == tr["trace_from"]:
                prof = start_profiler()
                span = torch.profiler.record_function(WINDOW)
                span.__enter__()
            batch = self.feed.batch()
            start = clock()
            self.params, self.state, m = self.step(self.params, self.state,
                                                   batch)
            sync(self.device)
            steps.append({"start": start, "end": clock(),
                          "tokens": self.feed.B * self.feed.S,
                          "loss_finite": bool(torch.isfinite(m["loss"])),
                          "profiled": profiled})
            if profiled and i == tr["trace_from"] + tr["trace_steps"] - 1:
                span.__exit__(None, None, None)
                prof.stop()
                trace = Trace.from_profiler(prof)
        return Run(kind="train", config=self.cell.config, traffic=tr,
                   setup_s=setup_s, window=(t0, clock()), steps=steps,
                   trace=trace, peak_bytes=peak_bytes(self.device))

    def close(self) -> None:
        del self.params, self.state, self.step
        free(self.device)


def reference_steps(cell, seed: int, device, prec=None, first_grad=None,
                    keep_first: bool = False) -> dict:
    """The reference's losses, first clipped gradient norms and change
    norms over the traffic's first `check_steps` steps, from the same
    weights and batches; with `first_grad` (a first clipped gradient a
    leaf, on the host), also each leaf's squared distance from it; with
    `keep_first`, its own first clipped gradient, on the host."""
    from reference import common
    from reference.adamw import AdamW
    common.no_tf32()
    prec = prec or common.FLOAT32
    tr = cell.traffic
    ref = spec.reference(cell.config)
    layout = ref.param_layout(cell.config)
    tree = model_weights(cell.config, device)
    dtypes = [p.dtype for p in tensors(tree)]
    flat = [p.float().requires_grad_() for p in tensors(tree)]
    del tree
    params = _rebuild(layout, iter(flat))
    adam = AdamW(tr["optimizer"], flat, dtypes)
    feed = Feed(tr, cell.config["vocab"], seed, device)
    losses, grad_norms, apart, kept = [], [], [], []

    def first(i, g):
        if first_grad is not None:
            apart.append(float(torch.sum(
                (first_grad[i].to(g.device) - g) ** 2)))
        if keep_first:
            kept.append(g.to("cpu"))

    for i in range(tr["check_steps"]):
        b = feed.batch()
        loss = ref.train_loss(cell.config, params, b["tokens"], b["labels"],
                              prec)
        grads = torch.autograd.grad(loss, flat)
        norms = adam.step(flat, grads, first if i == 0 else None)
        del grads
        losses.append(float(loss.detach()))
        if i == 0:
            grad_norms = norms
    with torch.no_grad():
        change = change_norms(params, cell.config, device)
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "grad_apart": apart, "first_grad": kept}


def _rebuild(layout, it):
    if "shape" in layout:
        return next(it)
    return {k: _rebuild(layout[k], it) for k in sorted(layout)}


def worst_leaf(got: list, want: list, keep=None) -> float:
    """max over leaves of |got - want| / max(want, the median leaf's
    want)."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    med = median([want[i] for i in idx])
    return max(abs(got[i] - want[i]) / max(want[i], med, 1e-30)
               for i in idx)


def compare(program: dict, reference: dict) -> dict:
    """The numbers the training cells' limits files name: `change_gap`, by
    the worst moved leaf the gap between the norms of the parameters'
    change over the steps, and, where either side measured it
    (`grad_apart`, a leaf's squared distance), `grad_error`: the first
    clipped gradient's distance from the reference's over the whole
    model, relative to the reference's norm.  `calibrate.py` reads the
    loss and gradient-norm gaps beside them."""
    g_ref = reference["grad_norms"]
    med = median(g_ref)
    moved = [g >= QUIET * med for g in g_ref]
    out = {"change_gap": worst_leaf(program["change_norms"],
                                    reference["change_norms"], moved)}
    if program.get("grad_apart") or reference.get("grad_apart"):
        apart = program.get("grad_apart") or reference["grad_apart"]
        out["grad_error"] = math.sqrt(sum(apart) / sum(g * g for g in g_ref))
    return out
