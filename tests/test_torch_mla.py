"""The port's multi-head latent attention (`repro_torch.models.attention.
mla_attention`, DeepSeek-V2) against the JAX package's, on weights made in
the reference and carried across with `params_from_numpy`.

Prefill (the latent decompressed per head, plain blocked attention with q
and k of D = qk_nope + qk_rope and v of D = v_dim) and the absorbed decode
(scores and values through the latent space, float32 einsums, the mask
`arange(T) <= cur_len`) at float32 rtol = atol = 2e-5 (the same float32
arithmetic, sums in another order) and bfloat16 at 2e-2 (the reference's
bf16 kernel tolerance).  Then the twin of the reference's
`test_prefill_then_decode_matches_full_forward` (`tests/test_models.py`:
rtol = atol = 2e-3), which holds the latent cache, and the kernel path's
two rules: `kv_norm` reaches the rmsnorm wrapper as a contiguous tensor, and
MLA's attention on the CPU reaches neither the flash attention wrapper nor
its own prefill kernel's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import TOL, normal

from repro.models import attention as ref_attn
from repro.models.module import init_from_specs as ref_init

from repro_torch.configs import ARCHS, reduce_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import mla_attention as mla_kernel
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models import zoo
from repro_torch.models.module import init_from_specs

torch.set_num_threads(2)

B, S, T, H = 2, 9, 16, 4
MLA = dict(n_heads=H, qk_nope=16, qk_rope=8, v_dim=12, kv_lora=32,
           rope_theta=1e4)


def _carried(dtype):
    jd = getattr(jnp, dtype)
    specs = ref_attn.mla_specs(48, H, MLA["qk_nope"], MLA["qk_rope"],
                               MLA["v_dim"], MLA["kv_lora"], jd)
    rp = ref_init(specs, jax.random.PRNGKey(3))
    # a kv_norm scale away from ones, so that the norm's scale counts
    rp = dict(rp, kv_norm=jnp.asarray(1 + normal((MLA["kv_lora"],), 4, 0.3)
                                      ).astype(jd))
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _inputs(dtype, n, seed):
    x = normal((B, n, 48), seed)
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.as_tensor(x).to(getattr(torch, dtype)))


def _cache(dtype, seed=None):
    """Latent caches of length T, both packages: zeros, or (with `seed`) a
    filled history, so that the absorbed decode reads real positions."""
    shapes = {"ckv": (B, T, MLA["kv_lora"]), "kr": (B, T, MLA["qk_rope"])}
    arrays = {k: np.zeros(s, np.float32) if seed is None else
              normal(s, seed + i) for i, (k, s) in enumerate(shapes.items())}
    ref = {k: jnp.asarray(a).astype(getattr(jnp, dtype))
           for k, a in arrays.items()}
    port = {k: torch.as_tensor(a).to(getattr(torch, dtype))
            for k, a in arrays.items()}
    return ref, port


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _positions(n, base=0):
    pos = np.broadcast_to(base + np.arange(n), (B, n)).copy()
    return jnp.asarray(pos, jnp.int32), torch.as_tensor(pos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches_the_reference(dtype):
    rp, p = _carried(dtype)
    jx, x = _inputs(dtype, S, 5)
    jpos, pos = _positions(S)
    want, none = ref_attn.mla_attention(rp, jx, jpos, **MLA)
    got, cache = attn.mla_attention(p, x, pos, **MLA)
    assert none is None and cache is None
    assert got.dtype == x.dtype and got.shape == (B, S, 48)
    _close(got, want, dtype)
    # with a cache, prefill fills positions [0, S) of the latent cache
    rc, pc = _cache(dtype)
    want, rc = ref_attn.mla_attention(rp, jx, jpos, cache=rc, **MLA)
    got, out = attn.mla_attention(p, x, pos, cache=pc, **MLA)
    assert out is pc
    _close(got, want, dtype)
    for k in ("ckv", "kr"):
        _close(pc[k], rc[k], dtype)
        assert not pc[k][:, S:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cur_len", [0, 7, T - 1])
def test_mla_absorbed_decode_matches_the_reference(dtype, cur_len):
    rp, p = _carried(dtype)
    jx, x = _inputs(dtype, 1, 6)
    jpos, pos = _positions(1, cur_len)
    rc, pc = _cache(dtype, seed=10)
    want, rc = ref_attn.mla_attention(rp, jx, jpos, cache=rc,
                                      cur_len=jnp.int32(cur_len), **MLA)
    got, out = attn.mla_attention(p, x, pos, cache=pc, cur_len=cur_len,
                                  **MLA)
    assert out is pc and got.dtype == x.dtype
    _close(got, want, dtype)
    for k in ("ckv", "kr"):
        _close(pc[k], rc[k], dtype)


def test_mla_decode_masks_past_cur_len():
    """Positions after cur_len do not reach the output; cur_len itself
    (the token just written) does."""
    _, p = _carried("float32")
    _, x = _inputs("float32", 1, 6)
    _, pos = _positions(1, 5)
    outs = []
    for fill in (0.0, 9.0):
        _, pc = _cache("float32", seed=10)
        for k in pc:
            pc[k][:, 6:] = fill
        outs.append(attn.mla_attention(p, x, pos, cache=pc, cur_len=5,
                                       **MLA)[0])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-34b",
                                  "deepseek-v2-236b"])
def test_prefill_then_decode_matches_full_forward(arch):
    """Greedy continuation from (prefill + decode) == slicing a longer
    teacher-forced forward pass (KV and latent cache correctness), as the
    reference's test holds its own models (rtol = atol = 2e-3)."""
    cfg = dataclasses.replace(reduce_config(ARCHS[arch]), dtype=torch.float32)
    if cfg.moe:
        # capacity drops depend on batch composition; a no-drop factor makes
        # prefill+decode comparable with the teacher-forced pass
        cfg = dataclasses.replace(cfg, moe=dict(cfg.moe, capacity_factor=16.0))
    params = init_from_specs(zoo.build_param_specs(cfg), 0, device="cpu",
                             dtype_override=torch.float32)
    n = 16
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(1, n + 1)))
    x, _, _ = tfm.decoder_forward(cfg, params, toks)
    full = tfm.lm_head(cfg, params, x)
    caches = init_from_specs(zoo.build_cache_specs(cfg, 1, n + 4), 1,
                             device="cpu", dtype_override=torch.float32)
    lg_pre, caches = zoo.prefill(cfg, params, {"tokens": toks[:, :n]}, caches)
    lg_dec, _ = zoo.decode_step(cfg, params, toks[:, n:], caches, n)
    np.testing.assert_allclose(lg_pre.numpy(), full[:, n - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lg_dec.numpy(), full[:, n].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("n_tokens", [S, 1])
def test_kernel_path_norms_a_contiguous_latent_and_never_calls_flash(
        monkeypatch, n_tokens):
    """On the kernel path the rmsnorm wrapper gets the latent as a
    contiguous copy of the strided `kv[..., :kv_lora]` view (the wrapper
    refuses a strided one on the card), and MLA's attention stays plain:
    neither the flash attention wrapper (it takes only k and v of one
    shape) nor MLA's own prefill wrapper (it takes only CUDA tensors from
    the model) is reached."""
    normed = []

    def rmsnorm_fwd(x, scale, eps=1e-5):
        normed.append(x.is_contiguous())
        return layers.rmsnorm(x, scale, eps)

    def refuse(*args, **kwargs):
        raise AssertionError("MLA reached the flash attention wrapper")

    monkeypatch.setattr(layers, "rmsnorm_fwd", rmsnorm_fwd)
    monkeypatch.setattr(layers, "flash_attention_fwd", refuse)
    monkeypatch.setattr(layers, "decode_attention_fwd", refuse)
    monkeypatch.setattr(mla_kernel, "mla_attention_fwd", refuse)
    _, p = _carried("float32")
    _, x = _inputs("float32", n_tokens, 5)
    _, pos = _positions(n_tokens, 0 if n_tokens > 1 else 4)
    _, pc = _cache("float32", seed=10)
    plain, _ = attn.mla_attention(p, x, pos, cache=dict(pc), cur_len=4,
                                  **MLA)
    _, pc = _cache("float32", seed=10)
    got, _ = attn.mla_attention(p, x, pos, cache=pc, cur_len=4,
                                kernels=True, **MLA)
    assert normed == [True]
    np.testing.assert_allclose(got.numpy(), plain.numpy(),
                               **TOL["float32"])


def test_mla_cache_specs_match_the_reference():
    cfg = reduce_config(ARCHS["deepseek-v2-236b"])
    specs = attn.mla_cache_specs(cfg, 3, 20)
    assert {k: s.shape for k, s in specs.items()} == {
        "ckv": (3, 20, cfg.mla["kv_lora"]), "kr": (3, 20, cfg.mla["qk_rope"])}
    assert zoo.build_cache_specs(cfg, 3, 20)["layers"]["ckv"].shape == (
        cfg.n_layers - 1, 3, 20, cfg.mla["kv_lora"])
