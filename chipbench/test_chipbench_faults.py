"""A whole run on the CPU at a small size with the timed path broken
underneath: `correct` has to come out false, for each fault the cell can
have (one chip: no exchange between chips to leave out).  Each fault is
planted in the program's module attributes that its calls go through."""
import time

import pytest
import torch

from harness.cell_run import run_cell
from harness.small import small_cell

SERVING = ("dsmoe-prefill-2k", "rwkv6-prefill-4k")
TRAINING = ("dsmoe-train-4k", "rwkv6-train-4k")


def altered_token(monkeypatch):
    """Every decode step puts the next token of the vocabulary first."""
    from repro_torch.models import zoo
    step = zoo.decode_step

    def wrong(*a, **kw):
        logits, caches = step(*a, **kw)
        return torch.roll(logits, 1, dims=-1), caches
    monkeypatch.setattr(zoo, "decode_step", wrong)


def half_the_batch(monkeypatch):
    """The prefill computes the first half of the rows only and hands
    their results to the other half too."""
    from repro_torch.models import zoo
    prefill = zoo.prefill

    def half(cfg, params, batch, caches, **kw):
        t = batch["tokens"]
        n = t.shape[0] // 2
        t = torch.cat([t[:n], t[:n]])
        return prefill(cfg, params, dict(batch, tokens=t), caches, **kw)
    monkeypatch.setattr(zoo, "prefill", half)


def state_unchanged(monkeypatch):
    """The prefill and every decode step leave the caches as they found
    them."""
    from repro_torch.models import zoo

    def frozen(step):
        def call(cfg, params, batch, caches, *a, **kw):
            keep = [t.clone() for t in _leaves(caches)]
            logits, caches = step(cfg, params, batch, caches, *a, **kw)
            for t, k in zip(_leaves(caches), keep):
                t.copy_(k)
            return logits, caches
        return call
    monkeypatch.setattr(zoo, "prefill", frozen(zoo.prefill))
    monkeypatch.setattr(zoo, "decode_step", frozen(zoo.decode_step))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def train_state_unchanged(monkeypatch):
    """The training step returns its parameters and moments unchanged."""
    from repro_torch.train import train_step

    def idle(cfg, params, grads, state, **kw):
        return params, dict(state, step=state["step"] + 1), {
            "grad_norm": torch.zeros(()), "lr": torch.zeros(())}
    monkeypatch.setattr(train_step, "adamw_update", idle)


def train_half_batch(monkeypatch):
    """The loss is the mean over the first half of the rows only."""
    from repro_torch.models import zoo
    loss = zoo.train_loss

    def half(cfg, params, batch, **kw):
        n = batch["tokens"].shape[0] // 2
        return loss(cfg, params, {k: v[:n] for k, v in batch.items()}, **kw)
    monkeypatch.setattr(zoo, "train_loss", half)


def run(name):
    return run_cell(small_cell(name), 12345, 0.3, False,
                    torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("fault", (altered_token, half_the_batch,
                                   state_unchanged), ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", SERVING)
def test_serving_faults_come_out_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line = run(name)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", (train_state_unchanged, train_half_batch),
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", TRAINING)
def test_training_faults_come_out_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line = run(name)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("name", SERVING + TRAINING)
def test_without_a_fault_the_same_run_is_correct(name):
    assert run(name)["correct"] is True
