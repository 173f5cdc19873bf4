"""The port's configs and decoders (`repro_torch.configs`,
`repro_torch.models`) against the JAX package's, on weights initialised in
the reference and carried across with `repro_torch.interop`.

Reduced llama3.2-3b (GQA, GLU, RMSNorm), granite-34b (MQA, GELU MLP),
qwen2-vl-72b (M-RoPE, its three streams equal as text positions give),
zamba2-2.7b (Mamba2 layers and the shared attention block), rwkv6-3b (time
mix and channel mix), deepseek-moe-16b (a dense first layer, then the
capacity MoE) and deepseek-v2-236b (MLA, then the capacity MoE) run
`decoder_forward`, `prefill` and two `decode_step`s; qwen2-vl also with
three different M-RoPE streams.  All ten configs, whisper included, run the
twin of the reference's prefill-and-decode smoke test against the
reference's logits.
Tolerances: float32 variants at 2e-5 (the same float32 arithmetic, sums in
another order); bfloat16 at 2e-2 (the reference's bf16 kernel tolerance:
the two frameworks round bf16 activations at slightly different places, one
bf16 ulp each, and the residual stream carries them through the layers);
for the Mamba2, RWKV6 and MoE stacks in bfloat16 `DEEP_BF16`
(`_torch_inputs.py`, where the reference's own spread is measured).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import DEEP_BF16, TOL

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import reduce_config as ref_reduce
from repro.launch.mesh import compat_make_mesh, compat_set_mesh
from repro.models import encdec as ref_encdec
from repro.models import transformer as ref_tfm
from repro.models import zoo as ref_zoo
from repro.models.module import count_params as ref_count
from repro.models.module import init_from_specs as ref_init
from repro.models.module import param_bytes as ref_bytes

from repro_torch.configs import ARCHS, SHAPES, reduce_config
from repro_torch.interop import arch_config_from_dict, params_from_numpy
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models import zoo
from repro_torch.models.module import (ParamSpec, count_params,
                                       init_from_specs, param_bytes)

B, S, MAX_LEN = 2, 12, 20
DENSE = ["llama3.2-3b", "granite-34b", "qwen2-vl-72b"]
DECODERS = DENSE + ["zamba2-2.7b", "rwkv6-3b", "deepseek-moe-16b",
                    "deepseek-v2-236b"]
# the three families the port refused until MLA, M-RoPE and whisper landed
ONCE_REFUSED = ["whisper-large-v3", "qwen2-vl-72b", "deepseek-v2-236b"]


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_arch_configs_equal_the_reference(name):
    ref = REF_ARCHS[name]
    assert arch_config_from_dict(dataclasses.asdict(ref)) == ARCHS[name]
    small = ref_reduce(ref)
    assert arch_config_from_dict(dataclasses.asdict(small)) == \
        reduce_config(ARCHS[name])


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_param_counts_bytes_and_flops_equal_the_reference(name):
    ref_specs = ref_zoo.build_param_specs(REF_ARCHS[name])
    specs = zoo.build_param_specs(ARCHS[name])
    assert count_params(specs) == ref_count(ref_specs) == \
        ARCHS[name].param_count()
    assert param_bytes(specs) == ref_bytes(ref_specs)
    assert zoo.active_params(ARCHS[name]) == \
        ref_zoo.active_params(REF_ARCHS[name])
    for shape in SHAPES:
        assert zoo.model_flops(ARCHS[name], SHAPES[shape]) == \
            ref_zoo.model_flops(REF_ARCHS[name], REF_SHAPES[shape])


def test_init_from_specs_keeps_the_reference_distribution():
    specs = {"w": ParamSpec((64, 256), torch.float32),
             "e": ParamSpec((256, 16), torch.float32, scale=0.02),
             "z": ParamSpec((8,), torch.bfloat16, init="zeros"),
             "o": ParamSpec((8,), torch.bfloat16, init="ones")}
    p = init_from_specs(specs, 0, device="cpu")
    again = init_from_specs(specs, torch.Generator().manual_seed(0),
                            device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in specs)
    assert abs(float(p["w"].std()) - 1 / 8) < 0.01       # 1/sqrt(fan_in)
    assert abs(float(p["e"].std()) - 0.02) < 0.002
    assert torch.equal(p["z"], torch.zeros(8, dtype=torch.bfloat16))
    assert torch.equal(p["o"], torch.ones(8, dtype=torch.bfloat16))


def _variant(name, dtype):
    rc = dataclasses.replace(ref_reduce(REF_ARCHS[name]), dtype=dtype)
    return rc, arch_config_from_dict(dataclasses.asdict(rc))


@pytest.fixture(scope="module", params=[(n, d) for n in DECODERS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    """Both packages' outputs on one reduced config: the cacheless forward,
    the prefill logits and two decode steps, fed the reference's tokens."""
    name, dtype = request.param
    rc, pc = _variant(name, getattr(jnp, dtype))
    rparams = ref_init(ref_zoo.build_param_specs(rc), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    toks = np.random.default_rng(0).integers(1, rc.vocab, size=(B, S))
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    ref, port = {}, {}
    with compat_set_mesh(mesh):
        ref["hidden"], _, _ = ref_tfm.decoder_forward(
            rc, rparams, jnp.asarray(toks, jnp.int32), mesh=mesh)
        caches = ref_init(ref_zoo.build_cache_specs(rc, B, MAX_LEN),
                          jax.random.PRNGKey(0))
        ref["prefill"], caches = ref_zoo.prefill(
            rc, rparams, {"tokens": jnp.asarray(toks, jnp.int32)}, caches,
            mesh=mesh)
        tok = jnp.argmax(ref["prefill"], -1).astype(jnp.int32)
        steps = [np.array(tok)]
        for i in range(2):
            ref[f"decode{i}"], caches = ref_zoo.decode_step(
                rc, rparams, tok[:, None], caches, jnp.int32(S + i),
                mesh=mesh)
            tok = jnp.argmax(ref[f"decode{i}"], -1).astype(jnp.int32)
            steps.append(np.array(tok))
    port["hidden"], none, _ = tfm.decoder_forward(pc, params,
                                                  torch.as_tensor(toks))
    assert none is None
    caches = init_from_specs(zoo.build_cache_specs(pc, B, MAX_LEN), 0,
                             device="cpu")
    port["prefill"], caches = zoo.prefill(
        pc, params, {"tokens": torch.as_tensor(toks)}, caches)
    for i in range(2):
        port[f"decode{i}"], caches = zoo.decode_step(
            pc, params, torch.as_tensor(steps[i]).long()[:, None], caches,
            S + i)
    return name, dtype, ref, port


@pytest.mark.parametrize("what", ["hidden", "prefill", "decode0", "decode1"])
def test_dense_decoder_matches_the_reference(run, what):
    name, dtype, ref, port = run
    got, want = port[what], np.asarray(ref[what], np.float32)
    if what != "hidden":
        assert got.dtype == torch.float32      # logits are float32
    assert got.shape == want.shape
    tol = TOL[dtype]
    if dtype == "bfloat16" and name not in DENSE:
        tol = DEEP_BF16["hidden" if what == "hidden" else "logits"]
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("name", ONCE_REFUSED)
def test_unsupported_families_raise_naming_the_roadmap(name):
    """Whisper, MLA and M-RoPE are accepted now: nothing of the three
    raises `NotImplementedError`.  (The name dates from when the port
    refused them, naming the ROADMAP item that would port each.)"""
    for cfg in (ARCHS[name], reduce_config(ARCHS[name])):
        tfm.check_supported(cfg)
        specs = zoo.build_cache_specs(cfg, 1, 8)
        assert specs and zoo.build_param_specs(cfg)
    cfg = reduce_config(ARCHS[name])
    params = init_from_specs(zoo.build_param_specs(cfg), 0, device="cpu")
    caches = init_from_specs(zoo.build_cache_specs(cfg, 1, 8), 0,
                             device="cpu")
    batch = {"tokens": torch.ones(1, 4, dtype=torch.long)}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.zeros(1, cfg.enc["enc_len"], cfg.d_model,
                                          dtype=cfg.dtype)
    logits, _ = zoo.prefill(cfg, params, batch, caches)
    assert logits.shape == (1, cfg.vocab)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_check_supported_accepts_every_config(name):
    tfm.check_supported(ARCHS[name])
    with pytest.raises(ValueError, match="unknown mixer"):
        tfm.check_supported(dataclasses.replace(ARCHS[name], mixer="lstm"))


def test_qwen2_vl_three_mrope_streams_match_the_reference():
    """Reduced qwen2-vl-72b in float32 with three different position
    streams (a vision prompt's t, h and w), prefill logits and hidden state
    at 2e-5; the same prompt with equal streams answers otherwise."""
    rc, pc = _variant("qwen2-vl-72b", jnp.float32)
    rparams = ref_init(ref_zoo.build_param_specs(rc), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(11)
    toks = rng.integers(1, rc.vocab, size=(B, S))
    pos = np.stack([np.broadcast_to(np.arange(S), (B, S)),
                    rng.integers(0, 3 * S, (B, S)),
                    rng.integers(0, 3 * S, (B, S))])
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    with compat_set_mesh(mesh):
        want_h, _, _ = ref_tfm.decoder_forward(
            rc, rparams, jnp.asarray(toks, jnp.int32), mesh=mesh,
            mrope_positions=jnp.asarray(pos, jnp.int32))
        caches = ref_init(ref_zoo.build_cache_specs(rc, B, MAX_LEN),
                          jax.random.PRNGKey(0))
        want, _ = ref_zoo.prefill(
            rc, rparams, {"tokens": jnp.asarray(toks, jnp.int32),
                          "mrope_positions": jnp.asarray(pos, jnp.int32)},
            caches, mesh=mesh)
    got_h, _, _ = tfm.decoder_forward(pc, params, torch.as_tensor(toks),
                                      mrope_positions=torch.as_tensor(pos))
    caches = init_from_specs(zoo.build_cache_specs(pc, B, MAX_LEN), 0,
                             device="cpu")
    batch = {"tokens": torch.as_tensor(toks),
             "mrope_positions": torch.as_tensor(pos)}
    got, _ = zoo.prefill(pc, params, batch, caches)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               **TOL["float32"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    text, _ = zoo.prefill(pc, params, {"tokens": torch.as_tensor(toks)},
                          init_from_specs(zoo.build_cache_specs(pc, B,
                                                                MAX_LEN), 0,
                                          device="cpu"))
    assert float((text - got).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_arch_smoke_prefill_decode(arch):
    """Twin of the reference's smoke test of the same name (reduced config,
    its bf16 default, B 2, S 32, prefill then one decode step; whisper with
    frame embeddings, qwen2-vl with M-RoPE positions), on the reference's
    weights: finite logits of the right shape, equal to the reference's at
    2e-2 (dense) or `DEEP_BF16` (the recurrent and MoE stacks)."""
    rc = ref_reduce(REF_ARCHS[arch])
    pc = arch_config_from_dict(dataclasses.asdict(rc))
    rparams = ref_init(ref_zoo.build_param_specs(rc), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    n, seq = 2, 32
    rng = np.random.default_rng(7)
    toks = rng.integers(0, rc.vocab, size=(n, seq))
    rbatch = {"tokens": jnp.asarray(toks, jnp.int32)}
    batch = {"tokens": torch.as_tensor(toks)}
    if rc.family == "encdec":
        e = rng.standard_normal((n, rc.enc["enc_len"], rc.d_model)).astype(
            np.float32)
        rbatch["enc_embeds"] = jnp.asarray(e).astype(rc.dtype)
        batch["enc_embeds"] = torch.as_tensor(e).to(pc.dtype)
    if rc.rope == "mrope":
        pos = np.broadcast_to(np.arange(seq)[None, None], (3, n, seq)).copy()
        rbatch["mrope_positions"] = jnp.asarray(pos, jnp.int32)
        batch["mrope_positions"] = torch.as_tensor(pos)
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    with compat_set_mesh(mesh):
        caches = ref_init(ref_zoo.build_cache_specs(rc, n, seq + 4),
                          jax.random.PRNGKey(1))
        want, caches = ref_zoo.prefill(rc, rparams, rbatch, caches, mesh=mesh)
        renc = None
        if rc.family == "encdec":
            renc = ref_encdec.encode(rc, rparams, rbatch["enc_embeds"],
                                     mesh=mesh)
        tok = jnp.argmax(want, -1)[:, None].astype(jnp.int32)
        want2, _ = ref_zoo.decode_step(rc, rparams, tok, caches,
                                       jnp.int32(seq), mesh=mesh,
                                       enc_out=renc)
    caches = init_from_specs(zoo.build_cache_specs(pc, n, seq + 4), 0,
                             device="cpu")
    got, caches = zoo.prefill(pc, params, batch, caches)
    enc = None
    if pc.family == "encdec":
        enc = encdec.encode(pc, params, batch["enc_embeds"])
    got2, _ = zoo.decode_step(pc, params, torch.as_tensor(np.array(tok)),
                              caches, seq, enc_out=enc)
    assert got.shape == (n, pc.vocab) and got2.shape == (n, pc.vocab)
    assert bool(torch.isfinite(got).all() and torch.isfinite(got2).all())
    tol = TOL["bfloat16"]
    if pc.mixer in ("rwkv6", "mamba2") or pc.ffn == "moe":
        tol = DEEP_BF16["logits"]
    for a, b in ((got, want), (got2, want2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   **tol)


def test_kernels_off_the_card_raise():
    cfg = reduce_config(ARCHS["llama3.2-3b"])
    params = init_from_specs(zoo.build_param_specs(cfg), 0, device="cpu")
    caches = init_from_specs(zoo.build_cache_specs(cfg, 1, 8), 0,
                             device="cpu")
    tok = torch.zeros(1, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="kernels=True"):
        zoo.decode_step(cfg, params, tok, caches, 0, kernels=True)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_kv_seq_shard_on_one_rank_mesh_equals_unsharded_step(dtype, tol):
    """`decode_step(kv_seq_shard=True)` on a one-rank host mesh (no process
    group: every collective skipped) runs the split-KV decode
    (`decode_attention_kv_sharded`, which normalises p after PV) and
    equals the plain step (softmax, then PV) within the kernels'
    tolerances (`tests/test_kernels.py:17-19`); without a mesh it is the
    plain step, as in the reference."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device_type="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    cfg = dataclasses.replace(reduce_config(ARCHS["llama3.2-3b"]),
                              dtype=dtype)
    params = init_from_specs(zoo.build_param_specs(cfg), 0, device="cpu")
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab, (2, 8)))
    got, want, plain = [], [], []
    # the plain step first; the others feed its tokens
    for out, kw in ((want, {}), (got, dict(mesh=mesh, kv_seq_shard=True)),
                    (plain, dict(kv_seq_shard=True))):
        caches = init_from_specs(zoo.build_cache_specs(cfg, 2, 16), 0,
                                 device="cpu")
        logits, caches = zoo.prefill(cfg, params, {"tokens": prompt},
                                     caches, **kw)
        for t in range(3):
            out.append(logits)
            tok = torch.argmax(want[t] if out is not want else logits,
                               -1)[:, None]
            logits, caches = zoo.decode_step(cfg, params, tok, caches,
                                             8 + t, **kw)
        out.append(logits)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(p, w)
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("name,kernel,per_prefill,per_step", [
    ("llama3.2-3b", "flash_attention", 28, 0),
    ("llama3.2-3b", "decode_attention", 0, 28),
    ("zamba2-2.7b", "ssd_scan", 54, 0),
    ("zamba2-2.7b", "flash_attention", 9, 0),
    ("rwkv6-3b", "rwkv6_scan", 32, 0),
    ("deepseek-moe-16b", "moe_gemm", 81, 81),
    ("whisper-large-v3", "flash_attention", 96, 32),
    ("whisper-large-v3", "decode_attention", 0, 32),
    ("whisper-large-v3", "rmsnorm", 0, 0),
    ("qwen2-vl-72b", "rmsnorm", 161, 161),
    ("qwen2-vl-72b", "flash_attention", 80, 0),
    ("qwen2-vl-72b", "decode_attention", 0, 80),
    ("deepseek-v2-236b", "rmsnorm", 181, 181),
    ("deepseek-v2-236b", "moe_gemm", 177, 177),
    ("deepseek-v2-236b", "mla_attention", 60, 0),
    ("deepseek-v2-236b", "flash_attention", 0, 0),
    ("deepseek-v2-236b", "decode_attention", 0, 0)])
def test_kernel_launches_per_pass_of_the_served_models(name, kernel,
                                                       per_prefill, per_step):
    # one launch per layer that runs the kernel: 28 attention layers, 54
    # Mamba2 layers under 9 shared-block applications, 32 RWKV6 layers,
    # three expert products in each of 27 MoE layers; whisper's 32 encoder
    # layers and 32 decoder layers of self and cross attention (layernorm
    # throughout), a decode step's cross attention at S = 1 on the flash
    # kernel; deepseek-v2's three norms a layer (ln1, MLA's kv_norm, ln2)
    # and MLA's prefill attention on its own kernel (its absorbed decode
    # plain), its expert products in 59 MoE layers
    pre, step = zoo.kernel_launches(ARCHS[name])
    assert (pre.get(kernel, 0), step.get(kernel, 0)) == (per_prefill,
                                                         per_step)
