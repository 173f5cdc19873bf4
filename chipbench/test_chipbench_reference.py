"""The plain reference against the program's plain path on the CPU at
small widths, both in float32: served logits through prefill and the
decode steps (MoE capacity routing over each call of the model), the
training loss and its gradients, and AdamW."""
import numpy as np
import pytest
import torch

from harness import serve, spec
from harness.small import small_cell
from harness.weights import make_weights
from reference import common
from reference.adamw import AdamW

CELLS = ("dsmoe-prefill-2k", "rwkv6-prefill-4k")


def as_f32(tree):
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    return tree.float()


@pytest.mark.parametrize("name", CELLS)
def test_served_logits_match_the_program(name):
    from repro_torch.models import zoo
    from repro_torch.serve.engine import Request, ServeEngine
    cell = small_cell(name, dtype="float32")
    tr = cell.traffic
    params = make_weights(spec.reference(cell.config).param_layout(
        cell.config), 7, "cpu")
    engine = ServeEngine(spec.arch_config(cell.config), as_f32(params),
                         batch_slots=tr["batch_slots"],
                         max_len=tr["prompt_len"] + tr["new_tokens"],
                         prompt_len=tr["prompt_len"], device="cpu")
    prompts = serve.Feed(tr, cell.config["vocab"], 7).wave(tr["clients"])
    caught = []
    saved = zoo.prefill, zoo.decode_step

    def keep(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            caught.append(out[0].clone())
            return out
        return call
    zoo.prefill, zoo.decode_step = keep(saved[0]), keep(saved[1])
    try:
        reqs = [Request(prompt=p, max_new_tokens=tr["new_tokens"])
                for p in prompts]
        engine.serve(reqs)
    finally:
        zoo.prefill, zoo.decode_step = saved
    got = torch.stack(caught, 1)
    wave = {"prompts": prompts, "out": [r.out_tokens for r in reqs]}
    want = serve.reference_logits(cell, params, wave, ["cpu"],
                                  common.FLOAT32)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)
    assert float(serve.gaps(want, torch.as_tensor(wave["out"])).max()) \
        < 1e-3


def test_capacity_drops_happen_in_the_small_moe():
    """Left padding sends every pad to the same experts, over capacity:
    the check covers the drop rule, not only the routing."""
    from reference import moe_decoder
    cell = small_cell("dsmoe-prefill-2k", dtype="float32")
    p = common.layer_params(make_weights(moe_decoder.param_layout(
        cell.config), 3, "cpu")["layers"], 0)["ffn"]
    x = torch.randn(256, 128)
    x[:128] = x[0]                       # a run of identical rows
    _, e, _, kept = moe_decoder.route(p, x, 2, common.FLOAT32)
    assert not bool(kept.all())
    assert int(kept.sum()) <= 8 * moe_decoder.capacity(256, 2, 8)


@pytest.mark.parametrize("name", ("dsmoe-train-4k", "rwkv6-train-4k"))
def test_training_loss_and_gradients_match_the_program(name):
    from repro_torch.models import zoo
    cell = small_cell(name, dtype="float32")
    ref = spec.reference(cell.config)
    tree = as_f32(make_weights(ref.param_layout(cell.config), 5, "cpu"))
    leaves = [p.requires_grad_() for p in _leaves(tree)]
    g = torch.Generator().manual_seed(5)
    t = torch.randint(0, cell.config["vocab"], (2, 65), generator=g)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    got = zoo.train_loss(spec.arch_config(cell.config), tree, batch)
    g_got = torch.autograd.grad(got, leaves)
    want = ref.train_loss(cell.config, tree, batch["tokens"],
                          batch["labels"])
    g_want = torch.autograd.grad(want, leaves)
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=1e-5)
    for a, b in zip(g_got, g_want):
        scale = float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= 1e-4 * scale


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_adamw_matches_the_program_optimizer():
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             init_opt_state)
    opt = spec.cell("dsmoe-train-4k").traffic["optimizer"]
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 3, 2)]
    p_prog = {f"w{i}": torch.tensor(rng.standard_normal(s),
                                    dtype=torch.float32)
              for i, s in enumerate(shapes)}
    p_ref = [v.clone() for v in _leaves(p_prog)]
    state = init_opt_state(p_prog)
    adam = AdamW(opt, p_ref, [torch.float32] * 3)
    for step in range(3):
        grads = {k: torch.tensor(rng.standard_normal(v.shape) * (step + 1),
                                 dtype=torch.float32)
                 for k, v in p_prog.items()}
        p_prog, state, _ = adamw_update(AdamWConfig(**opt), p_prog, grads,
                                        state)
        adam.step(p_ref, list(_leaves(grads)))
        for a, b in zip(_leaves(p_prog), p_ref):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("B,T,chunk", ((2, 70, 16), (1, 32, 32), (3, 5, 32)))
def test_rwkv_chunks_follow_the_recurrence(B, T, chunk):
    from reference.rwkv6 import wkv, wkv_by_token
    g = torch.Generator().manual_seed(B * T)
    r, k, v = (torch.randn(B, T, 3, 8, generator=g) for _ in range(3))
    logw = torch.clamp(-torch.nn.functional.softplus(
        -2 * torch.randn(B, T, 3, 8, generator=g)) - 0.5, -6.0, 0.0)
    u = torch.randn(3, 8, generator=g)
    want = wkv_by_token(r, k, v, logw, u)
    torch.testing.assert_close(wkv(r, k, v, logw, u, chunk), want,
                               rtol=1e-4, atol=1e-4 * float(want.abs().max()))
