"""The port's multi-device entry points on 2 and 4 gloo ranks, against the
JAX package on meshes of the same shapes (the reference's numbers come
from this process's 8 JAX host devices; the ranks import neither `jax`
nor `repro`):

- split-KV decode (`layers.decode_attention_kv_sharded`) at 2 and 4 ranks
  against the reference's and the port's one-device `decode_attention`,
  1e-5 in float32 and 2e-2 in bfloat16 (`tests/test_kernels.py:17-19`),
  with a `cur_len` that leaves whole shards masked;
- `moe_ffn(mesh=)` on a (2, 2) (data, model) mesh, output and aux
  (`_torch_mesh_cases.check_moe`);
- the twin of `test_serve.py::test_serve_on_multi_device_mesh`:
  `ServeEngine(mesh=)` on (2, 2), every request done, tokens in range,
  equal in bf16 to the reference's engine on a (2, 2) mesh and in float32
  to the port's one-device engine on the same weights;
- `zoo.prefill` + `decode_step(kv_seq_shard=True)` (and without it) on the
  2- and 4-rank host meshes against the one-device steps, float32, 1e-5;
- every other family (hybrid Mamba2, RWKV6, MoE, MLA, M-RoPE, whisper) on
  the 2-rank host mesh against one device, float32, 1e-5, and the MoE's
  `train_loss` gradients with its experts split over "model";
- two steps of `make_train_step(cfg, mesh, ...)` on the 2-rank host mesh
  against the reference's jitted step on a 2-device mesh, plain, with
  microbatches and with int8 compression, at `test_torch_train_step.py`'s
  tolerances;
- `launch.train.main` on 2 ranks against the same command in one process
  (same seed, bfloat16 smoke model): every parameter within 2e-2 of its
  leaf's largest magnitude (a one-ulp bf16 rounding of the summed
  gradients moves an AdamW update by up to its full size), and the
  checkpoint rank 0 wrote holds the one-process run's arrays, within the
  same tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_mesh_cases import check_moe, kv_cases, kv_reference, moe_cases
from _torch_mesh_worker import results, run, to_wire

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduce_config as ref_reduce
from repro.launch.mesh import compat_make_mesh, compat_set_mesh
from repro.models.module import init_from_specs as ref_init
from repro.models.zoo import build_param_specs as ref_param_specs
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.train_step import TrainStepConfig as RefStepConfig
from repro.train.train_step import init_train_state as ref_init_state
from repro.train.train_step import make_train_step as ref_make_step

from repro_torch.train.data import DataConfig, TokenStream

KV_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
          "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TINY = ("llama3.2-3b", dict(n_layers=2, d_model=64, n_heads=2, d_ff=128,
                            vocab=256), "float32")
SMOKE = ("llama3.2-3b", dict(n_layers=2, d_model=64, n_heads=4, d_ff=192,
                             vocab=2048), "bfloat16")
TRAIN_ARGV = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
              "--seq", "32", "--d-model", "64", "--layers", "2",
              "--ckpt-every", "100"]
STEP_CASES = {"plain": dict(), "microbatches": dict(microbatches=2),
              "grad_compress": dict(grad_compress=True)}
STEP_TOL = {"plain": 2e-4, "microbatches": 2e-4, "grad_compress": 1e-2}
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=30)
FAMILIES = ["zamba2-2.7b", "rwkv6-3b", "deepseek-moe-16b", "deepseek-v2-236b",
            "qwen2-vl-72b", "whisper-large-v3"]


def _ref_tiny(spec):
    name, kw, dtype = spec
    rc = dataclasses.replace(ref_reduce(REF_ARCHS[name], **kw),
                             dtype=getattr(jnp, dtype))
    return rc, ref_init(ref_param_specs(rc), jax.random.PRNGKey(0))


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max() or 1.0))


@pytest.fixture(scope="module")
def tiny():
    return _ref_tiny(TINY)


@pytest.fixture(scope="module")
def two(tmp_path_factory, tiny):
    d = tmp_path_factory.mktemp("two")
    rc, rparams = tiny
    data = TokenStream(DataConfig(vocab=rc.vocab, seq_len=32, global_batch=8))
    rng = np.random.default_rng(5)
    inputs = {"kv_cases": kv_cases(2), "cfg": TINY,
              "params": to_wire(jax.tree.map(np.asarray, rparams)),
              "prompt": rng.integers(1, rc.vocab, (4, 8)),
              "tokens": rng.integers(1, rc.vocab, (3, 4)),
              "batches": [data.global_batch(i) for i in range(2)],
              "step_cfgs": STEP_CASES, "opt": OPT,
              "train_argv": TRAIN_ARGV, "ckpt_dir": str(d / "ckpt")}
    inputs["families"] = FAMILIES
    out = run(2, ["kv_sharded", "decode_kv_mesh", "families_mesh",
                  "train_step_mesh", "launch_train_mesh"], d / "run", inputs)
    out["inputs"] = inputs
    return out


@pytest.fixture(scope="module")
def four(tmp_path_factory, tiny):
    d = tmp_path_factory.mktemp("four")
    rc, rparams = tiny
    src, sparams = _ref_tiny(SMOKE)
    rng = np.random.default_rng(5)
    inputs = {"kv_cases": kv_cases(4), "moe_cases": moe_cases([(2, 2)]),
              "cfg": TINY,
              "params": to_wire(jax.tree.map(np.asarray, rparams)),
              "prompt": rng.integers(1, rc.vocab, (4, 8)),
              "tokens": rng.integers(1, rc.vocab, (3, 4)),
              "serve_cfg": SMOKE,
              "serve_params": to_wire(jax.tree.map(np.asarray, sparams)),
              "prompts": np.random.default_rng(3).integers(
                  1, src.vocab, (3, 16))}
    out = run(4, ["kv_sharded", "moe_mesh", "serve_mesh", "decode_kv_mesh"],
              d / "run", inputs)
    out["inputs"] = inputs
    return out


def test_gloo_ranks_import_neither_jax_nor_repro(two, four):
    assert two["imports"] == [[]] * 2 and four["imports"] == [[]] * 4


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("i", range(4))
def test_kv_sharded_decode(two, four, world, i):
    out = {2: two, 4: four}[world]
    case = out["inputs"]["kv_cases"][i]
    want, plain = kv_reference(case, world)
    for got in results(out, "kv_sharded"):
        np.testing.assert_allclose(got[i], want, **KV_TOL[case["dtype"]])
        np.testing.assert_allclose(got[i], plain, **KV_TOL[case["dtype"]])


@pytest.mark.parametrize("i", range(len(moe_cases([(2, 2)]))))
def test_moe_ffn_on_a_2_by_2_mesh(four, i):
    check_moe(four["inputs"]["moe_cases"][i],
              [r[i] for r in results(four, "moe_mesh")])


def test_serve_on_multi_device_mesh(four):
    """Twin of test_serve.py::test_serve_on_multi_device_mesh.  The (2, 2)
    engine's tokens equal the reference's engine on a (2, 2) mesh of the
    same weights.  On (2, 2) the dense layers run tensor-parallel and
    their row-parallel outputs sum over "model" in bf16, as GSPMD's
    partitioned products do; a greedy near tie of this random model then
    goes the reference's way, where the port's one-device bf16 engine
    goes the other (tokens 1944 and 1985 of the third request).  In
    float32 the sum is exact to float rounding: there the (2, 2) engine's
    tokens equal the one-device engine's."""
    from repro.serve.engine import Request as RefRequest
    from repro.serve.engine import ServeEngine as RefEngine
    src, sparams = _ref_tiny(SMOKE)
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    engine = RefEngine(src, sparams, mesh=mesh, batch_slots=2, max_len=48,
                       prompt_len=16)
    reqs = [RefRequest(prompt=np.asarray(p), max_new_tokens=4)
            for p in four["inputs"]["prompts"]]
    engine.serve(reqs)
    want = [(r.done, list(r.out_tokens)) for r in reqs]
    vocab = src.vocab
    for r in results(four, "serve_mesh"):
        assert all(done and len(toks) == 4 for done, toks in r["mesh"])
        assert all(0 <= t < vocab for _, toks in r["mesh"] for t in toks)
        assert r["mesh"] == want
        assert r["mesh_f32"] == r["plain_f32"]
        # each rank holds one of the two cache rows (batch over data)
        assert r["mesh_cache"][1] == 1 and r["plain_cache"][1] == 2


@pytest.mark.parametrize("world", [2, 4])
def test_decode_steps_on_the_host_mesh(two, four, world):
    for r in results({2: two, 4: four}[world], "decode_kv_mesh"):
        for name in ("kv", "rows"):
            for got, want in zip(r[name], r["plain"]):
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        # split-KV: every row, T / world positions; rows: B / world rows
        assert r["kv_cache"][1:3] == (4, 16 // world)
        assert r["rows_cache"][1:3] == (4 // world, 16)


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_on_the_two_rank_host_mesh(two, arch):
    """Hybrid Mamba2, RWKV6, MoE, MLA + MoE, M-RoPE and whisper: prefill
    and two decode steps on the (2, 1) host mesh (rows over "data", the
    weights gathered a layer at a time) equal the one-device steps in
    float32 (1e-5)."""
    for r in results(two, "families_mesh"):
        plain, meshed = r[arch]
        for got, want in zip(meshed, plain):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_moe_gradients_with_experts_split_over_model(two):
    """`zoo.train_loss` of the MoE on a (1, 2) mesh (each expert's d_ff
    split over "model", the router, tokens and weights of routing whole):
    the loss and every gathered gradient equal one device's (1e-5 of the
    leaf's largest magnitude): `copy_to` / `reduce_from` around the
    expert products give the reference's gradient."""
    for r in results(two, "families_mesh"):
        (loss1, g1), (loss2, g2) = r["moe_tp_grads"]
        np.testing.assert_allclose(loss2, loss1, rtol=1e-6)
        assert len(g1) == len(g2)
        for got, want in zip(g2, g1):
            _close(got, want, 1e-5)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_on_two_ranks_matches_the_reference(two, tiny, case):
    rc, rparams = tiny
    kw = STEP_CASES[case]
    rcfg = RefStepConfig(remat=True, opt=RefAdamWConfig(**OPT), **kw)
    mesh = compat_make_mesh((2, 1), ("data", "model"))
    rstep = jax.jit(ref_make_step(rc, mesh, rcfg))
    rstate = ref_init_state(rc, rparams, rcfg)
    rp, want = rparams, []
    for b in two["inputs"]["batches"]:
        with compat_set_mesh(mesh):
            rp, rstate, rm = rstep(rp, rstate, {k: jnp.asarray(v)
                                                for k, v in b.items()})
        want.append({k: float(rm[k]) for k in ("loss", "grad_norm", "lr")})
    leaves = jax.tree.leaves(rp)
    for r in results(two, "train_step_mesh"):
        got = r[case]
        assert got["step"] == 2
        for g, w in zip(got["metrics"], want):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5)
        assert len(got["params"]) == len(leaves)
        for g, w in zip(got["params"], leaves):
            _close(g, w, STEP_TOL[case])
    # the blocks are a half of the parameters, less the unsplit norms
    n = sum(x.size for x in leaves)
    assert all(r[case]["local"] < 0.6 * n
               for r in results(two, "train_step_mesh"))


def test_launch_train_on_two_ranks(two, tmp_path, capsys):
    """`launch.train.main` on the 2-rank host mesh equals the one-process
    run; rank 0's checkpoint holds the gathered parameters."""
    from repro_torch.launch.train import main
    from repro_torch.models.module import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    want = main(TRAIN_ARGV + ["--ckpt-dir", str(tmp_path / "one")])
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
    res = results(two, "launch_train_mesh")
    assert "mesh={'data': 2, 'model': 1}" in res[0]["log"]
    for r in res:
        for g, w in zip(r["params"], tree_leaves(want)):
            _close(g, w.float().numpy(), 2e-2)
    if ckpt.zstandard is None:
        return
    flat = ckpt.restore(two["inputs"]["ckpt_dir"], 2)
    one = ckpt.restore(str(tmp_path / "one"), 2)
    assert sorted(flat) == sorted(one)
    for k in flat:
        _close(flat[k].float().numpy(), one[k].float().numpy(), 2e-2)
    assert int(flat["['opt']/['step']"]) == 2
