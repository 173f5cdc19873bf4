"""The port's tensor-parallel dense layers over "model" (GQA on whole
heads, the GLU / GELU FFNs on d_ff, the vocab-parallel embedding, head and
cross entropy) on 2 and 4 gloo ranks, against the JAX package on host
meshes of the same shapes, where GSPMD runs the same layout (the
reference's numbers come from this process's 8 JAX host devices; the
ranks import neither `jax` nor `repro`):

- serving: `zoo.prefill` and 4 `decode_step`s of reduced llama3.2-3b,
  qwen2-vl-72b (three M-RoPE streams), granite-34b (MQA, GELU),
  deepseek-moe-16b (dense first layer and attention split, the experts'
  d_ff split) and whisper-large-v3 (encoder, self and cross attention) at
  (1, 2), (2, 2) and (1, 4), float32, and llama in bfloat16 at (2, 2),
  every rank's logits within `_torch_inputs.TOL` of the reference's
  jitted steps;
- split-KV decode (`kv_seq_shard=True`) with the heads split, at (2, 2);
- the fallback: heads that do not split on whole heads (12 heads over 3
  KV heads: 6 or 3 a rank straddle a KV head) and a vocabulary of 510
  that 4 ranks do not divide run gathered, and still equal the reference;
- training: `zoo.train_loss` (remat on) and every gradient leaf, put back
  from the ranks' blocks, of reduced llama (GQA), granite (MQA, whose one
  KV head feeds every rank's heads; GELU's `in_b` sliced, `out_b` after
  the sum) and whisper at (1, 2) and (2, 2) against the reference's
  jitted `value_and_grad`, the loss 1e-5 relative and every gradient 1e-5
  of its leaf's largest magnitude (`test_torch_train_step.py`'s
  tolerance of m): a `wk`/`wv` or `in_b` gradient left unsummed over
  "model", or an `out_b` summed again, is off by a factor of 2 or more;
- `gather_from`, `max_over` and the vocab-parallel lookup with their
  gradients against whole tensors in one process;
- the split rule on the production meshes (no ranks needed).
"""
import numpy as np
import pytest
from _torch_inputs import TOL
from _torch_mesh_cases import (tp_case, tp_serve_reference,
                               tp_train_reference)
from _torch_mesh_worker import results, run

from repro_torch.configs import ARCHS
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import heads_split, kv_range
from repro_torch.sharding.rules import Mesh

SERVE_ARCHS = ["llama3.2-3b", "qwen2-vl-72b", "granite-34b",
               "deepseek-moe-16b", "whisper-large-v3"]
MESHES = [(1, 2), (2, 2), (1, 4)]
# 12 heads over 3 KV heads (G 4): 6 or 3 heads a rank straddle a KV
# head; a vocabulary of 510 splits over 2 ranks, not 4
FALLBACK = ("llama3.2-3b", {"d_model": 192, "n_heads": 12, "vocab": 510},
            "float32", {"n_kv_heads": 3})
TRAIN_ARCHS = ["llama3.2-3b", "granite-34b", "whisper-large-v3"]
GRAD_RTOL = 1e-5


def _tag(mesh):
    return "x".join(map(str, mesh))


def _serve_cases() -> list:
    out = [tp_case(f"{a}-{_tag(m)}", (a, {}, "float32"), m)
           for a in SERVE_ARCHS for m in MESHES]
    out.append(tp_case("llama3.2-3b-bf16-2x2", ("llama3.2-3b", {},
                                                "bfloat16"), (2, 2)))
    out.append(tp_case("llama3.2-3b-kv-2x2", ("llama3.2-3b", {}, "float32"),
                       (2, 2), kv=True))
    out += [tp_case(f"fallback-{_tag(m)}", FALLBACK, m)
            for m in ((1, 2), (1, 4))]
    return out


def _train_cases() -> list:
    return [tp_case(f"{a}-{_tag(m)}", (a, {}, "float32"), m, train=True,
                    seed=7) for a in TRAIN_ARCHS for m in ((1, 2), (2, 2))]


SERVE = {c["id"]: c for c in _serve_cases()}
TRAIN = {c["id"]: c for c in _train_cases()}


def _spawn(world, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"tp{world}")
    inputs = {"tp_serve": [c for c in SERVE.values()
                           if c["mesh"][0] * c["mesh"][1] == world],
              "tp_train": [c for c in TRAIN.values()
                           if c["mesh"][0] * c["mesh"][1] == world]}
    return run(world, ["tp_serve", "tp_train", "tp_collectives"], d, inputs)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


def _ranks(two, four, case, scenario):
    world = case["mesh"][0] * case["mesh"][1]
    out = [[r for r in rank if r["id"] == case["id"]]
           for rank in results({2: two, 4: four}[world], scenario)]
    assert all(len(r) == 1 for r in out) and len(out) == world
    return [r[0] for r in out]


def _expected_split(case) -> dict:
    """The blocks the split rule runs tensor-parallel in each reduced
    config (4 heads: 2 or 1 a rank; d_ff 256, vocabulary 512)."""
    name = case["cfg"][0]
    if case["cfg"] == FALLBACK:
        return {"layers": ["ffn"], "vocab": case["mesh"][1] == 2}
    if name == "whisper-large-v3":
        return {"enc_layers": ["attn", "ffn"],
                "dec_layers": ["cross", "ffn", "self"], "vocab": True}
    if name == "deepseek-moe-16b":
        return {"dense_layers": ["ffn", "mixer"], "layers": ["mixer"],
                "vocab": True}
    return {"layers": ["ffn", "mixer"], "vocab": True}


def test_gloo_ranks_import_neither_jax_nor_repro(two, four):
    assert two["imports"] == [[]] * 2 and four["imports"] == [[]] * 4


@pytest.mark.parametrize("case_id", sorted(SERVE))
def test_tensor_parallel_serving_equals_the_reference(two, four, case_id):
    """Prefill and 4 decode steps: every rank's whole logits within TOL of
    the reference's on a JAX mesh of the same shape; the blocks run split
    are the rule's."""
    case = SERVE[case_id]
    want = tp_serve_reference(case)
    tol = TOL[case["cfg"][2]]
    for r in _ranks(two, four, case, "tp_serve"):
        assert r["split"] == _expected_split(case)
        assert len(r["logits"]) == len(want)
        for got, w in zip(r["logits"], want):
            assert got.shape == w.shape
            np.testing.assert_allclose(got, w, **tol)


def test_split_kv_decode_with_split_heads(two, four):
    """Split-KV at (2, 2): each rank's cache holds every row, its half of
    the positions (T over "data") and every KV head (the heads over
    "model" each fill and read their own range of it); without split-KV
    its half of the rows.  Its logits are held to the reference's with
    the other serving cases."""
    case = SERVE["llama3.2-3b-kv-2x2"]
    for r in _ranks(two, four, case, "tp_serve"):
        assert r["cache"] == (2, 4, 8, 4, 32)    # (L, B, T/2, Hkv, Dh)
    rows = SERVE["llama3.2-3b-2x2"]
    for r in _ranks(two, four, rows, "tp_serve"):
        assert r["cache"] == (2, 2, 16, 4, 32)   # (L, B/2, T, Hkv, Dh)


@pytest.mark.parametrize("case_id", sorted(TRAIN))
def test_tensor_parallel_gradients_equal_the_reference(two, four, case_id):
    case = TRAIN[case_id]
    want_loss, want = tp_train_reference(case)
    for r in _ranks(two, four, case, "tp_train"):
        assert r["split"] == _expected_split(case)
        np.testing.assert_allclose(r["loss"], want_loss, rtol=GRAD_RTOL)
        assert len(r["grads"]) == len(want)
        for got, w in zip(r["grads"], want):
            assert got.shape == w.shape
            np.testing.assert_allclose(
                got, w, rtol=GRAD_RTOL,
                atol=GRAD_RTOL * float(np.abs(w).max() or 1.0))


def test_split_blocks_hold_local_heads_and_d_ff(two, four):
    """At (1, 2) a rank's blocks of llama's split leaves are half their
    heads' columns or rows, half the d_ff and half the vocabulary; `wk`
    and `wv` stay whole (2 layers stacked)."""
    case = TRAIN["llama3.2-3b-1x2"]
    D, F, V = 128, 256, 512
    for r in _ranks(two, four, case, "tp_train"):
        shapes = dict(zip(_leaf_names(case), r["local"]))
        assert shapes["layers.mixer.wq"] == (2, D, D // 2)
        assert shapes["layers.mixer.wo"] == (2, D // 2, D)
        assert shapes["layers.mixer.wk"] == (2, D, D)
        assert shapes["layers.ffn.gate"] == (2, D, F // 2)
        assert shapes["layers.ffn.down"] == (2, F // 2, D)
        assert shapes["embed"] == (V // 2, D)


def _leaf_names(case):
    """Dotted names of a case's parameter leaves, in tree order."""
    def walk(tree, prefix):
        if isinstance(tree, dict) and "__bf16__" not in tree:
            for k in sorted(tree):
                yield from walk(tree[k], f"{prefix}{k}.")
        else:
            yield prefix[:-1]
    return list(walk(case["params"], ""))


@pytest.mark.parametrize("world", [2, 4])
def test_vocab_parallel_collectives(two, four, world):
    for r in results({2: two, 4: four}[world], "tp_collectives"):
        for name, (got, want) in r.items():
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                                           err_msg=name)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_split_rule_on_the_production_meshes(multi_pod):
    """On (16, 16) and (2, 16, 16): attention splits on whole heads for the
    64-head configs, granite's 48 (3 a rank over its one KV head) and
    deepseek-moe's 16, not for llama's 24 or whisper's 20; every dense
    d_ff splits; the vocabulary splits but for whisper's 51866."""
    from repro_torch.launch.mesh import production_layout
    mesh = Mesh.abstract(*production_layout(multi_pod), device_type="cpu")
    attn = {a for a, c in ARCHS.items() if c.mixer == "gqa"
            and heads_split(c.n_heads, c.n_kv_heads, mesh)}
    assert attn == {"command-r-35b", "deepseek-67b", "qwen2-vl-72b",
                    "granite-34b", "deepseek-moe-16b"}
    # granite: 3 heads a rank over its one KV head; the 64-head configs:
    # 4 heads a rank, half of one KV head's 8
    assert kv_range(48, 1, mesh) == kv_range(64, 8, mesh) == (0, 1)
    for name, cfg in ARCHS.items():
        sh = tfm.param_shardings(cfg, mesh)
        group = "dec_layers" if cfg.family == "encdec" else "layers"
        split = tfm.split_blocks(cfg, tfm.layer_shardings(sh[group]))
        mixer = "self" if cfg.family == "encdec" else "mixer"
        assert (mixer in split) == (name in attn), name
        assert ("ffn" in split) == (cfg.ffn in ("glu", "gelu")), name
        assert (tfm.vocab_tp(cfg, mesh) is mesh) == \
            (name != "whisper-large-v3"), name
