"""DeepSeek-V2's published mechanisms in the port, against the plain float32
reference of the chip benchmark (`chipbench/reference/mla_moe_decoder.py`,
which imports nothing of the port) on seeded weights at a small shape:
MLA with low-rank queries (`wq_a`, `q_norm`, `wq_b`), YaRN rotary
frequencies and temperature, group-limited greedy routing with the weights
left unnormalised and scaled.

- YaRN's correction range, frequencies and temperature at the published
  values (factor 40 over 4096 positions, beta 32 / 1, mscale 0.707);
- group-limited routing against a brute force over the kept groups;
- the port's prefill, then absorbed decode steps through the latent cache
  (`ServeEngine`), against the reference's full forward pass on one device
  and on (1, 2) and (1, 4) gloo ranks through `ServeEngine(mesh=)`;
- two mutants that must fail: the decode without YaRN's temperature, and
  the routing weights renormalised;
- the tensor-parallel gradients of `wq_a` and `q_norm` at (1, 2) against
  one process, and their sums over "model" taken out (`PART_LEAVES`).

Every comparison is float32; each tolerance says why.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_mesh_worker import results, run, to_wire

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models import zoo

BENCH = Path(__file__).resolve().parents[1] / "chipbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.weights import make_weights  # noqa: E402
from reference import mla_moe_decoder as ref  # noqa: E402

YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
        "type": "yarn"}
# 4 heads of 32 + 16 rotary, a query latent of 48; 16 experts in 4 groups,
# 2 kept, top 3, weights unnormalised and scaled 16 (DeepSeek-V2's form)
CFG = ArchConfig(
    name="dsv2-small", family="moe", n_layers=3, d_model=128, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=64, vocab=512, mixer="mla", ffn="moe",
    rope_scaling=YARN, dtype=torch.float32,
    mla={"q_lora": 48, "kv_lora": 32, "qk_nope": 32, "qk_rope": 16,
         "v_dim": 32},
    moe={"n_routed": 16, "top_k": 3, "n_shared": 1, "d_ff_expert": 64,
         "first_dense_layers": 1, "d_ff_dense": 256, "n_group": 4,
         "topk_group": 2, "norm_topk": False, "routed_scaling": 16.0})
PROMPT_LEN, NEW, SLOTS = 48, 4, 4
# float32 sums in other orders (blocked against whole attention, absorbed
# against decompressed decode, experts in slots against one at a time)
# over 3 layers, whose routed outputs are scaled 16: observed under 3e-6
ATOL = 2e-5


def ref_config(cfg: ArchConfig) -> dict:
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out.pop("dtype")
    return out


def weights(cfg: ArchConfig = CFG, seed: int = 7) -> dict:
    """The seeded float32 tree in the reference's (and the port's) layout,
    drawn as the chip benchmark draws it."""
    tree = make_weights(ref.param_layout(ref_config(cfg)), seed, "cpu")
    return _map(tree, lambda t: t.float())


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def prompts(seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab, size=n) for n in (48, 31, 17, 40)]


def serve_logits(cfg: ArchConfig, params, ps) -> tuple:
    """(float32 logits (B, NEW, V): the prefill's, then each decode
    step's; the served tokens) of `ServeEngine` on one device."""
    from repro_torch.serve.engine import Request, ServeEngine
    engine = ServeEngine(cfg, params, batch_slots=SLOTS,
                         max_len=PROMPT_LEN + NEW, prompt_len=PROMPT_LEN,
                         device="cpu")
    caught, saved = [], (zoo.prefill, zoo.decode_step)

    def keep(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            caught.append(out[0].clone())
            return out
        return call
    zoo.prefill, zoo.decode_step = keep(saved[0]), keep(saved[1])
    try:
        reqs = [Request(prompt=p, max_new_tokens=NEW) for p in ps]
        engine.serve(reqs)
    finally:
        zoo.prefill, zoo.decode_step = saved
    return torch.stack(caught, 1), [list(r.out_tokens) for r in reqs]


def reference_logits(params, ps, out) -> torch.Tensor:
    """The reference's logits over the left-padded prompts and the served
    tokens fed back, at the positions the engine's steps predicted."""
    tokens = np.zeros((len(ps), PROMPT_LEN), np.int64)
    for i, p in enumerate(ps):
        tokens[i, PROMPT_LEN - len(p):] = p
    tokens = np.concatenate([tokens, np.asarray(out)[:, :-1]], axis=1)
    return ref.serve_logits(ref_config(CFG), params, torch.as_tensor(tokens),
                            PROMPT_LEN)


@pytest.fixture(scope="module")
def served():
    params = weights()
    ps = prompts()
    got, out = serve_logits(CFG, params, ps)
    return params, ps, got, out, reference_logits(params, ps, out)


# ---------------------------------------------------------------------------
# YaRN and the routing
# ---------------------------------------------------------------------------

def test_yarn_range_and_frequencies_at_the_published_values():
    assert layers.yarn_range(64, 1e4, YARN) == (10, 23)
    inv = layers.yarn_frequencies(64, 1e4, YARN)
    extra = 1e4 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    ramp = torch.clamp((torch.arange(32, dtype=torch.float64) - 10) / 13,
                       0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    np.testing.assert_allclose(inv.numpy(), want.numpy(), rtol=1e-6)
    # below `low` the plain frequencies, above `high` a 40th of them
    np.testing.assert_allclose(inv[:11].numpy(), extra[:11].numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(inv[23:].numpy(), (extra[23:] / 40).numpy(),
                               rtol=1e-6)


def test_yarn_temperature():
    m = layers.yarn_mscale(40, 0.707)
    assert m == pytest.approx(0.1 * 0.707 * math.log(40) + 1)
    assert round(m, 4) == 1.2608 and round(m * m, 4) == 1.5896
    assert attn.mla_temperature(YARN) == pytest.approx(m * m)
    assert attn.mla_temperature(None) == 1.0
    assert layers.yarn_mscale(1, 0.707) == 1.0


def test_yarn_rope_scales_cos_and_sin_by_the_mscale_ratio():
    """cos and sin times m(s, mscale) / m(s, mscale_all_dim): 1 as
    published, so a rotation keeps each pair's norm; 1.2608 where
    mscale_all_dim is 0 (float32 rotations: 1e-5)."""
    x = torch.randn(1, 5, 2, 64, dtype=torch.float64)
    pos = torch.arange(5)[None]
    kept = layers.apply_rope(x, pos, 1e4, YARN)
    np.testing.assert_allclose(kept.norm(dim=-1).numpy(),
                               x.norm(dim=-1).numpy(), rtol=1e-5)
    grown = layers.apply_rope(x, pos, 1e4, dict(YARN, mscale_all_dim=0))
    np.testing.assert_allclose(grown.numpy(),
                               (kept * layers.yarn_mscale(40, 0.707)).numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown rope_scaling"):
        layers.apply_rope(x, pos, 1e4, dict(YARN, type="linear"))


def _brute_route(p, top_k, n_group, topk_group):
    n, E = p.shape
    size = E // n_group
    experts, w = [], []
    for row in p.tolist():
        best = [max(row[g * size:(g + 1) * size]) for g in range(n_group)]
        kept = sorted(range(n_group), key=lambda g: -best[g])[:topk_group]
        cand = [e for g in kept for e in range(g * size, (g + 1) * size)]
        top = sorted(cand, key=lambda e: -row[e])[:top_k]
        experts.append(top)
        w.append([row[e] for e in top])
    return np.asarray(w), np.asarray(experts)


@pytest.mark.parametrize("n_group,topk_group,top_k", [(4, 2, 3), (8, 3, 6),
                                                      (2, 1, 2)])
def test_group_limited_routing_against_brute_force(n_group, topk_group,
                                                   top_k):
    E = 8 * n_group
    g = torch.Generator().manual_seed(n_group)
    p = torch.softmax(torch.randn(64, E, generator=g), dim=-1)
    want_w, want_e = _brute_route(p, top_k, n_group, topk_group)
    w, e = layers.route(p, top_k, {"n_group": n_group,
                                   "topk_group": topk_group,
                                   "norm_topk": False,
                                   "routed_scaling": 16.0})
    assert (e.numpy() == want_e).all()
    np.testing.assert_allclose(w.numpy(), 16 * want_w, rtol=1e-6)
    # renormalised where norm_topk holds (its default)
    w, _ = layers.route(p, top_k, {"n_group": n_group,
                                   "topk_group": topk_group})
    np.testing.assert_allclose(w.numpy(), want_w / want_w.sum(
        -1, keepdims=True), rtol=1e-6)


def test_routing_without_the_keys_is_the_plain_top_k():
    g = torch.Generator().manual_seed(0)
    p = torch.softmax(torch.randn(32, 16, generator=g), dim=-1)
    w, e = layers.route(p, 3, {"n_routed": 16, "top_k": 3})
    tv, ti = torch.topk(p, 3, dim=-1)
    assert torch.equal(e, ti)
    assert torch.equal(w, tv / torch.clamp_min(tv.sum(-1, keepdim=True),
                                               1e-9))


def test_published_widths_split_on_whole_heads():
    """q_lora's block is its own kind: `wq_b`'s heads split over "model",
    `wq_a` and `q_norm` whole and summed over "model" in the backward."""
    from repro_torch.sharding.rules import Mesh
    cfg = dataclasses.replace(CFG, n_layers=60, d_model=5120, n_heads=128,
                              mla=dict(CFG.mla, q_lora=1536, kv_lora=512,
                                       qk_nope=128, qk_rope=64, v_dim=128))
    mesh = Mesh.abstract((1, 4), ("data", "model"), device_type="cpu")
    sh = tfm.param_shardings(cfg, mesh)
    layer = tfm.layer_shardings(sh["layers"])
    assert tfm.block_kind(layer["mixer"]) == "mla_lora"
    assert tfm.split_blocks(cfg, layer) == {"mixer"}
    assert tfm.PART_LEAVES["mla_lora"] >= {"wq_a", "q_norm"}
    assert layer["mixer"]["wq_b"].local_shape((1536, 128 * 192)) == \
        (1536, 32 * 192)
    assert layer["mixer"]["wq_a"].local_shape((5120, 1536)) == (5120, 1536)
    # ln1, kv_norm, q_norm and ln2 a layer, and the final norm
    prefill, decode = zoo.kernel_launches(cfg, mesh)
    assert prefill["rmsnorm"] == decode["rmsnorm"] == 4 * 60 + 1


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

def test_served_logits_match_the_reference(served):
    params, ps, got, out, want = served
    assert got.shape == want.shape == (SLOTS, NEW, CFG.vocab)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    # the routing drops rows and the groups bind: the test reaches both
    flat = torch.cat([params["layers"]["ffn"]["router"][0]]).shape
    assert flat == (CFG.d_model, 16)


def test_mutant_without_the_temperature_in_decode_fails(served):
    """The absorbed decode scoring without YaRN's m^2 (1.59): the prefill's
    logits still match, the decode steps' leave the tolerance by far."""
    params, ps, _, _, _ = served
    whole, temperature = attn.mla_attention, attn.mla_temperature

    def mutant(params_, x, *a, **kw):
        if x.shape[1] == 1:
            attn.mla_temperature = lambda sc: 1.0
        try:
            return whole(params_, x, *a, **kw)
        finally:
            attn.mla_temperature = temperature
    attn.mla_attention = mutant
    try:
        got, out = serve_logits(CFG, params, ps)
    finally:
        attn.mla_attention = whole
    want = reference_logits(params, ps, out)
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=0, atol=ATOL)
    assert float((got[:, 1:] - want[:, 1:]).abs().max()) > 100 * ATOL


def test_mutant_renormalising_the_routing_weights_fails(served):
    params, ps, _, _, _ = served
    cfg = dataclasses.replace(CFG, moe=dict(CFG.moe, norm_topk=True))
    got, out = serve_logits(cfg, params, ps)
    want = reference_logits(params, ps, out)
    assert float((got - want).abs().max()) > 100 * ATOL


# ---------------------------------------------------------------------------
# tensor-parallel, on gloo ranks
# ---------------------------------------------------------------------------

GRAD_LEAVES = ["layers.mixer.wq_a", "layers.mixer.q_norm",
               "dense_layers.mixer.wq_a", "dense_layers.mixer.q_norm",
               "layers.mixer.wq_b", "layers.mixer.wkv_a"]
GRAD_RTOL = 1e-5        # `test_torch_tensor_parallel.py`'s, of the leaf's
                        # largest magnitude


def _inputs(params):
    cfg = ref_config(CFG)
    cfg["dtype"] = "float32"
    ps = prompts()
    g = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(1, CFG.vocab, (2, 32), generator=g),
             "labels": torch.randint(1, CFG.vocab, (2, 32), generator=g)}
    return {"dsv2": {"cfg": cfg, "params": to_wire(_map(
        params, lambda t: t.numpy())), "prompts": [p.tolist() for p in ps],
        "prompt_len": PROMPT_LEN, "new_tokens": NEW,
        "max_len": PROMPT_LEN + NEW,
        "batch": {k: v.numpy() for k, v in batch.items()},
        "grad_leaves": GRAD_LEAVES}}, batch


@pytest.fixture(scope="module")
def ranks(served, tmp_path_factory):
    params = served[0]
    inputs, batch = _inputs(params)
    out = {w: run(w, ["dsv2_serve"] + (["dsv2_grads"] if w == 2 else []),
                  tmp_path_factory.mktemp(f"dsv2_{w}"), inputs)
           for w in (2, 4)}
    return out, batch


@pytest.mark.parametrize("world", [2, 4])
def test_tensor_parallel_serving_matches_the_reference(served, ranks, world):
    """`ServeEngine(mesh=)` at (1, world): every rank's logits of the
    prefill and the decode steps against the reference's full forward
    pass over the tokens it served (ATOL: float32, the sums over "model"
    in another order too); MLA splits on whole heads in every layer."""
    params, ps, _, _, _ = served
    out, _ = ranks
    assert out[world]["imports"] == [[]] * world
    for r in results(out[world], "dsv2_serve"):
        assert r["split"] == {"dense_layers": ["ffn", "mixer"],
                              "layers": ["mixer"], "vocab": True}
        want = reference_logits(params, ps, r["out"]).numpy()
        got = np.stack(r["logits"], 1)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _one_process_grads(params, batch):
    from repro_torch.models.module import tree_leaves, tree_unflatten
    leaves = [x.detach().clone().requires_grad_() for x in
              tree_leaves(params)]
    loss = zoo.train_loss(CFG, tree_unflatten(params, leaves), batch,
                          remat=True)
    grads = tree_unflatten(params, list(torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True)))
    return float(loss.detach()), grads


def _at(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree.numpy()


def test_tensor_parallel_gradients_of_the_query_latent(served, ranks):
    """At (1, 2): the loss and the gradients of `wq_a`, `q_norm` (each rank
    a part, summed over "model"), `wq_b` and `wkv_a` equal one process's;
    with `wq_a` and `q_norm` taken out of `PART_LEAVES`, theirs leave the
    tolerance by far while the loss and the others hold."""
    params = served[0]
    out, batch = ranks
    want_loss, want = _one_process_grads(params, batch)
    for r in results(out[2], "dsv2_grads"):
        for case in ("summed", "unsummed"):
            np.testing.assert_allclose(r[case]["loss"], want_loss,
                                       rtol=GRAD_RTOL)
        for name in GRAD_LEAVES:
            w = _at(want, name)
            tol = GRAD_RTOL * float(np.abs(w).max())
            np.testing.assert_allclose(r["summed"]["grads"][name], w,
                                       rtol=GRAD_RTOL, atol=tol)
            err = float(np.abs(r["unsummed"]["grads"][name] - w).max())
            if name.split(".")[-1] in ("wq_a", "q_norm"):
                assert err > 10 * tol, (name, err)
            else:
                assert err <= tol, (name, err)
