"""The port's tensor-parallel layers over "model" (GQA, MLA, Mamba2 and
RWKV6's time mix on whole heads, the GLU / GELU FFNs and RWKV's channel
mix on d_ff, zamba2's shared block, the vocab-parallel embedding, head
and cross entropy) on 2 and 4 gloo ranks, against the JAX package on host
meshes of the same shapes, where GSPMD runs the same layout (the
reference's numbers come from this process's 8 JAX host devices; the
ranks import neither `jax` nor `repro`):

- serving: `zoo.prefill` and 4 `decode_step`s of reduced llama3.2-3b,
  qwen2-vl-72b (three M-RoPE streams), granite-34b (MQA, GELU),
  deepseek-moe-16b (dense first layer and attention split, the experts'
  d_ff split), whisper-large-v3 (encoder, self and cross attention),
  zamba2-2.7b (Mamba2 on 4 or 2 of 8 SSD heads, the shared block on 2 or
  1 of 4), rwkv6-3b (2 or 1 of 4 heads, d_ff 128 or 64) and
  deepseek-v2-236b (MLA on 2 or 1 of 4 heads) at (1, 2), (2, 2) and (1,
  4), float32, llama, zamba2 and rwkv6 in bfloat16 at (2, 2), every
  rank's logits within `_torch_inputs.TOL` of the reference's jitted
  steps (the recurrent stacks' bfloat16 within `DEEP_BF16`);
- two waves of zamba2 and rwkv6 at (1, 2): the second prefill starts
  from the state the first wave left, and each rank's heads of the
  recurrent state after it equal the reference's;
- split-KV decode (`kv_seq_shard=True`) with the heads split, at (2, 2);
- the fallback: heads that do not split on whole heads (12 heads over 3
  KV heads: 6 or 3 a rank straddle a KV head; RWKV6's 6 heads over 4
  ranks, whose channel mix still splits) and a vocabulary of 510 that 4
  ranks do not divide run gathered, and still equal the reference;
- training: `zoo.train_loss` (remat on) and every gradient leaf, put back
  from the ranks' blocks, of reduced llama (GQA), granite (MQA, whose one
  KV head feeds every rank's heads; GELU's `in_b` sliced, `out_b` after
  the sum), whisper, zamba2, rwkv6 and deepseek-v2 at (1, 2) and (2, 2)
  against the reference's jitted `value_and_grad`, the loss 1e-5
  relative and every gradient 1e-5 of its leaf's largest magnitude
  (`test_torch_train_step.py`'s tolerance of m);
- the gradient sums' mutants at (1, 2): a part leaf left unsummed over
  "model" (MLA's `wkv_a`, Mamba2's `dt_bias` and `in_proj`, RWKV's
  `mu_r`, `u` and `ln_out`) or the channel mix's whole `Wr` summed puts
  that leaf's gradient off by far more than the tolerance;
- `gather_from`, `max_over` and the vocab-parallel lookup with their
  gradients against whole tensors in one process;
- the split rule on the production meshes (no ranks needed).
"""
import numpy as np
import pytest
from _torch_inputs import DEEP_BF16, TOL
from _torch_mesh_cases import (tp_case, tp_serve_reference,
                               tp_train_reference)
from _torch_mesh_worker import results, run

from repro_torch.configs import ARCHS
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import heads_split, kv_range
from repro_torch.sharding.rules import Mesh

MIXERS = ["zamba2-2.7b", "rwkv6-3b", "deepseek-v2-236b"]
SERVE_ARCHS = ["llama3.2-3b", "qwen2-vl-72b", "granite-34b",
               "deepseek-moe-16b", "whisper-large-v3"] + MIXERS
MESHES = [(1, 2), (2, 2), (1, 4)]
# 12 heads over 3 KV heads (G 4): 6 or 3 heads a rank straddle a KV
# head; a vocabulary of 510 splits over 2 ranks, not 4
FALLBACK = ("llama3.2-3b", {"d_model": 192, "n_heads": 12, "vocab": 510},
            "float32", {"n_kv_heads": 3})
# RWKV6 with 6 heads of 32: its time mix splits over 2 ranks, not 4 (the
# layout still splits `Wr`'s 192 columns 4 ways, mid-head); its channel
# mix's d_ff 256 splits over both
RWKV_FALLBACK = ("rwkv6-3b", {"d_model": 192, "n_heads": 6}, "float32")
TRAIN_ARCHS = ["llama3.2-3b", "granite-34b", "whisper-large-v3"] + MIXERS
GRAD_RTOL = 1e-5
# (arch, block kind, "drop" or "add", leaf, its dotted name): a part leaf
# left unsummed over "model", or a whole one summed
MUTANTS = [("deepseek-v2-236b", "mla", "drop", "wkv_a", "layers.mixer.wkv_a"),
           ("zamba2-2.7b", "mamba2", "drop", "dt_bias",
            "layers.mixer.dt_bias"),
           ("zamba2-2.7b", "mamba2", "drop", "in_proj",
            "layers.mixer.in_proj"),
           ("rwkv6-3b", "rwkv_tm", "drop", "mu_r", "layers.mixer.tm.mu_r"),
           ("rwkv6-3b", "rwkv_tm", "drop", "u", "layers.mixer.tm.u"),
           ("rwkv6-3b", "rwkv_tm", "drop", "ln_out",
            "layers.mixer.tm.ln_out"),
           ("rwkv6-3b", "rwkv_cm", "add", "Wr", "layers.ffn.Wr")]


def _tag(mesh):
    return "x".join(map(str, mesh))


def _serve_cases() -> list:
    out = [tp_case(f"{a}-{_tag(m)}", (a, {}, "float32"), m)
           for a in SERVE_ARCHS for m in MESHES]
    out += [tp_case(f"{a}-bf16-2x2", (a, {}, "bfloat16"), (2, 2))
            for a in ("llama3.2-3b", "zamba2-2.7b", "rwkv6-3b")]
    out += [tp_case(f"{a}-waves-1x2", (a, {}, "float32"), (1, 2), waves=2,
                    seed=3) for a in ("zamba2-2.7b", "rwkv6-3b")]
    out.append(tp_case("llama3.2-3b-kv-2x2", ("llama3.2-3b", {}, "float32"),
                       (2, 2), kv=True))
    out += [tp_case(f"fallback-{_tag(m)}", FALLBACK, m)
            for m in ((1, 2), (1, 4))]
    out.append(tp_case("rwkv-fallback-1x4", RWKV_FALLBACK, (1, 4)))
    return out


def _train_cases() -> list:
    out = [tp_case(f"{a}-{_tag(m)}", (a, {}, "float32"), m, train=True,
                   seed=7) for a in TRAIN_ARCHS for m in ((1, 2), (2, 2))]
    out += [tp_case(f"mutant-{kind}-{how}-{leaf}", (a, {}, "float32"),
                    (1, 2), train=True, seed=7, mutate=(kind, how, leaf))
            for a, kind, how, leaf, _ in MUTANTS]
    return out


SERVE = {c["id"]: c for c in _serve_cases()}
TRAIN = {c["id"]: c for c in _train_cases() if not c["mutate"]}
MUTANT = {c["id"]: c for c in _train_cases() if c["mutate"]}
_REFERENCE = {}


def _train_reference(case):
    """`tp_train_reference` of a case, once for its config, mesh and
    inputs (a mutant shares its unmutated case's)."""
    key = (case["cfg"][0], case["mesh"])
    if key not in _REFERENCE:
        _REFERENCE[key] = tp_train_reference(case)
    return _REFERENCE[key]


def _spawn(world, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"tp{world}")
    inputs = {"tp_serve": [c for c in SERVE.values()
                           if c["mesh"][0] * c["mesh"][1] == world],
              "tp_train": [c for c in [*TRAIN.values(), *MUTANT.values()]
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
    if case["cfg"] == RWKV_FALLBACK:
        return {"layers": ["ffn"], "vocab": True}
    if name == "whisper-large-v3":
        return {"enc_layers": ["attn", "ffn"],
                "dec_layers": ["cross", "ffn", "self"], "vocab": True}
    if name in ("deepseek-moe-16b", "deepseek-v2-236b"):
        return {"dense_layers": ["ffn", "mixer"], "layers": ["mixer"],
                "vocab": True}
    if name == "zamba2-2.7b":
        return {"layers": ["mixer"], "shared_attn": ["attn", "ffn"],
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
    want, state = tp_serve_reference(case)
    tol = TOL[case["cfg"][2]]
    if case["cfg"][2] == "bfloat16" and case["cfg"][0] in MIXERS:
        tol = DEEP_BF16["logits"]
    for r in _ranks(two, four, case, "tp_serve"):
        assert r["split"] == _expected_split(case)
        assert len(r["logits"]) == len(want)
        for got, w in zip(r["logits"], want):
            assert got.shape == w.shape
            np.testing.assert_allclose(got, w, **tol)
        if case["waves"]:
            # this rank's heads of the state the second wave left
            h0, got = r["state"]
            assert got.shape[2] * case["mesh"][1] == state.shape[2]
            np.testing.assert_allclose(
                got, state[:, :, h0:h0 + got.shape[2]], **tol)


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
    want_loss, want = _train_reference(case)
    for r in _ranks(two, four, case, "tp_train"):
        assert r["split"] == _expected_split(case)
        np.testing.assert_allclose(r["loss"], want_loss, rtol=GRAD_RTOL)
        assert len(r["grads"]) == len(want)
        for got, w in zip(r["grads"], want):
            assert got.shape == w.shape
            np.testing.assert_allclose(
                got, w, rtol=GRAD_RTOL,
                atol=GRAD_RTOL * float(np.abs(w).max() or 1.0))


@pytest.mark.parametrize("case_id", sorted(MUTANT))
def test_gradient_sum_mutants_fail(two, four, case_id):
    """A part leaf left out of `transformer.PART_LEAVES`, or the channel
    mix's whole `Wr` put in, keeps the loss but puts that leaf's gradient
    off the reference's by at least 10x the tolerance of
    `test_tensor_parallel_gradients_equal_the_reference`."""
    case = MUTANT[case_id]
    leaf = next(m[4] for m in MUTANTS if m[1:4] == case["mutate"])
    want_loss, want = _train_reference(case)
    i = _leaf_names(case).index(leaf)
    w = want[i]
    for r in _ranks(two, four, case, "tp_train"):
        np.testing.assert_allclose(r["loss"], want_loss, rtol=GRAD_RTOL)
        err = float(np.abs(r["grads"][i] - w).max())
        assert err > 10 * GRAD_RTOL * float(np.abs(w).max()), (leaf, err)


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
    deepseek-moe's 16, not for llama's 24 or whisper's 20; deepseek-v2's
    MLA (8 of 128 heads a rank) and zamba2's Mamba2 (5 of 80) split,
    rwkv6's time mix (40 heads) does not; every dense d_ff and RWKV's
    channel mix split, and zamba2's shared block (2 of 32 heads, 640 of
    its d_ff); the vocabulary splits but for whisper's 51866."""
    from repro_torch.launch.mesh import production_layout
    mesh = Mesh.abstract(*production_layout(multi_pod), device_type="cpu")
    attn = {a for a, c in ARCHS.items() if c.mixer == "gqa"
            and heads_split(c.n_heads, c.n_kv_heads, mesh)}
    assert attn == {"command-r-35b", "deepseek-67b", "qwen2-vl-72b",
                    "granite-34b", "deepseek-moe-16b"}
    # granite: 3 heads a rank over its one KV head; the 64-head configs:
    # 4 heads a rank, half of one KV head's 8
    assert kv_range(48, 1, mesh) == kv_range(64, 8, mesh) == (0, 1)
    mixers = attn | {"deepseek-v2-236b", "zamba2-2.7b"}
    for name, cfg in ARCHS.items():
        sh = tfm.param_shardings(cfg, mesh)
        group = "dec_layers" if cfg.family == "encdec" else "layers"
        split = tfm.split_blocks(cfg, tfm.layer_shardings(sh[group]))
        mixer = "self" if cfg.family == "encdec" else "mixer"
        assert (mixer in split) == (name in mixers), name
        assert ("ffn" in split) == (cfg.ffn in ("glu", "gelu", "rwkv_cm")), \
            name
        assert (tfm.vocab_tp(cfg, mesh) is mesh) == \
            (name != "whisper-large-v3"), name
    zamba = ARCHS["zamba2-2.7b"]
    assert tfm.split_blocks(zamba, tfm.param_shardings(
        zamba, mesh)["shared_attn"]) == {"attn", "ffn"}


@pytest.mark.parametrize("name,shape,norms", [
    ("zamba2-2.7b", (1, 1), 2 * 54 + 2 * 9 + 1),
    ("zamba2-2.7b", (1, 2), 54 + 2 * 9 + 1),
    ("zamba2-2.7b", (16, 16), 54 + 2 * 9 + 1),
    ("rwkv6-3b", (1, 2), 2 * 32 + 1),
    ("rwkv6-3b", (16, 16), 3 * 32 + 1),
    ("deepseek-v2-236b", (1, 2), 3 * 60 + 1)])
def test_kernel_launches_count_the_split_norms_out(name, shape, norms):
    """`zoo.kernel_launches(cfg, mesh)` on one rank: where Mamba2 or
    RWKV6's time mix splits over "model", its norm over the split row
    (the gated norm, `ln_out`) is plain math and launches no `rmsnorm`
    (zamba2's 54 at model 2 and 16; rwkv6's 32 at model 2, none at 16,
    where its 40 heads stay gathered); MLA's `kv_norm` normalises whole
    rows and keeps its launch; the scans and attention kernels keep
    theirs."""
    from repro_torch.models import zoo
    cfg = ARCHS[name]
    mesh = Mesh.abstract(shape, ("data", "model"), device_type="cpu")
    pre, step = zoo.kernel_launches(cfg, mesh)
    assert pre["rmsnorm"] == step["rmsnorm"] == norms
    one_pre, one_step = zoo.kernel_launches(cfg)
    assert {k: v for k, v in pre.items() if k != "rmsnorm"} == \
        {k: v for k, v in one_pre.items() if k != "rmsnorm"}
    assert {k: v for k, v in step.items() if k != "rmsnorm"} == \
        {k: v for k, v in one_step.items() if k != "rmsnorm"}
