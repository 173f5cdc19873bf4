"""The port's Whisper-style encoder-decoder (`repro_torch.models.encdec`, and
its branches of `repro_torch.models.zoo`) against the JAX package's, on
reduced whisper-large-v3 weights made in the reference and carried across
with `params_from_numpy`, inputs made with numpy from a seed.

Tolerances: float32 at rtol = atol = 2e-5 (the same float32 arithmetic,
sums in another order); bfloat16 at 2e-2, the reference's bf16 kernel
tolerance (the frameworks round bf16 activations at slightly different
places, one bf16 ulp each).

The reference's cached decoder reads cross K/V from a cache that nothing
fills from the encoder output (ROADMAP queue 3, item 7); the port keeps
that behaviour, and `test_whisper_cached_prefill_ignores_the_encoder_as_
the_reference_does` pins it on both packages.  The uncached pass, where
cross attention reads a real encoder output, is held against the reference
as the second check.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import TOL, normal

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduce_config as ref_reduce
from repro.launch.mesh import compat_make_mesh, compat_set_mesh
from repro.models import encdec as ref_encdec
from repro.models import zoo as ref_zoo
from repro.models.module import init_from_specs as ref_init
from repro.serve.engine import ServeEngine as RefServeEngine

from repro_torch.interop import arch_config_from_dict, params_from_numpy
from repro_torch.models import encdec, zoo
from repro_torch.models.module import init_from_specs
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(2)

B, S, MAX_LEN = 2, 10, 16
NAME = "whisper-large-v3"


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    """(dtype, reference config, reference params, port config, port
    params, mesh) of reduced whisper."""
    dtype = request.param
    rc = dataclasses.replace(ref_reduce(REF_ARCHS[NAME]),
                             dtype=getattr(jnp, dtype))
    rparams = ref_init(ref_zoo.build_param_specs(rc), jax.random.PRNGKey(0))
    cfg = arch_config_from_dict(dataclasses.asdict(rc))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    return (dtype, rc, rparams, cfg, params,
            compat_make_mesh((1, 1), ("data", "model")))


def _embeds(cfg, seed):
    return normal((B, cfg.enc["enc_len"], cfg.d_model), seed)


def _both(a, dtype):
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _tokens(cfg, n, seed):
    t = np.random.default_rng(seed).integers(1, cfg.vocab, size=(B, n))
    return jnp.asarray(t, jnp.int32), torch.as_tensor(t)


def _close(got, want, dtype, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(tol or TOL[dtype]))


@pytest.mark.parametrize("d_model", [64, 1280])
@pytest.mark.parametrize("n_pos", [64, 1500])
def test_sinusoidal_matches_the_reference(d_model, n_pos):
    """The frequencies `exp(-log(1e4) i / (half - 1))` come from each
    framework's float32 exp: XLA's CPU exp is one ulp off the correctly
    rounded value for 44 of whisper's 640 frequencies, PyTorch's for 3. A
    frequency below 1 one ulp apart (at most 2**-24) turns the angle at
    position p by up to p * 2**-24, so the limit is two such ulps at the
    last position, n_pos * 2**-23 (1.8e-4 over whisper's 1500 frames), plus
    the sin and cos of the same argument, 1e-6."""
    pos = np.broadcast_to(np.arange(n_pos), (2, n_pos)).copy()
    got = encdec.sinusoidal(torch.as_tensor(pos), d_model)
    want = ref_encdec.sinusoidal(jnp.asarray(pos, jnp.int32), d_model)
    assert got.dtype == torch.float32 and got.shape == (2, n_pos, d_model)
    _close(got, want, "float32", rtol=0, atol=n_pos * 2.0 ** -23 + 1e-6)


def test_encode_matches_the_reference(model):
    dtype, rc, rparams, cfg, params, mesh = model
    jx, x = _both(_embeds(cfg, 1), dtype)
    with compat_set_mesh(mesh):
        want = ref_encdec.encode(rc, rparams, jx, mesh=mesh)
    got = encdec.encode(cfg, params, x)
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(got, want, dtype)


def test_uncached_decode_stack_matches_the_reference(model):
    """The pass in which cross attention reads the encoder output."""
    dtype, rc, rparams, cfg, params, mesh = model
    je, e = _both(_embeds(cfg, 2), dtype)
    jt, t = _tokens(cfg, S, 3)
    with compat_set_mesh(mesh):
        enc = ref_encdec.encode(rc, rparams, je, mesh=mesh)
        want, none = ref_encdec.decode_stack(rc, rparams, jt, enc, mesh=mesh)
    got, caches = encdec.decode_stack(cfg, params, t,
                                      encdec.encode(cfg, params, e))
    assert none is None and caches is None
    _close(got, want, dtype)


def test_cached_decode_stack_matches_the_reference(model):
    """Prefill at cur_len 0, then two decode steps, with the caches of
    `whisper_cache_specs`: hidden states and every cache."""
    dtype, rc, rparams, cfg, params, mesh = model
    je, e = _both(_embeds(cfg, 4), dtype)
    jt, t = _tokens(cfg, S + 2, 5)
    rcache = ref_init(ref_encdec.whisper_cache_specs(rc, B, MAX_LEN),
                      jax.random.PRNGKey(1))
    caches = init_from_specs(encdec.whisper_cache_specs(cfg, B, MAX_LEN), 0,
                             device="cpu")
    assert {k: tuple(v.shape) for k, v in caches.items()} == \
        {k: tuple(v.shape) for k, v in rcache.items()}
    enc = encdec.encode(cfg, params, e)
    with compat_set_mesh(mesh):
        renc = ref_encdec.encode(rc, rparams, je, mesh=mesh)
        for lo, hi in ((0, S), (S, S + 1), (S + 1, S + 2)):
            want, rcache = ref_encdec.decode_stack(
                rc, rparams, jt[:, lo:hi], renc, mesh=mesh, caches=rcache,
                cur_len=jnp.int32(lo))
            got, out = encdec.decode_stack(cfg, params, t[:, lo:hi], enc,
                                           caches=caches, cur_len=lo)
            assert out is caches
            _close(got, want, dtype)
    for k in caches:
        _close(caches[k], rcache[k], dtype)


def test_zoo_prefill_and_decode_match_the_reference(model):
    dtype, rc, rparams, cfg, params, mesh = model
    je, e = _both(_embeds(cfg, 6), dtype)
    jt, t = _tokens(cfg, S, 7)
    rcache = ref_init(ref_zoo.build_cache_specs(rc, B, MAX_LEN),
                      jax.random.PRNGKey(1))
    caches = init_from_specs(zoo.build_cache_specs(cfg, B, MAX_LEN), 0,
                             device="cpu")
    with compat_set_mesh(mesh):
        want, rcache = ref_zoo.prefill(rc, rparams, {"tokens": jt,
                                                     "enc_embeds": je},
                                       rcache, mesh=mesh)
        renc = ref_encdec.encode(rc, rparams, je, mesh=mesh)
        tok = jnp.argmax(want, -1).astype(jnp.int32)
        want2, _ = ref_zoo.decode_step(rc, rparams, tok[:, None], rcache,
                                       jnp.int32(S), mesh=mesh, enc_out=renc)
    got, caches = zoo.prefill(cfg, params, {"tokens": t, "enc_embeds": e},
                              caches)
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab)
    _close(got, want, dtype)
    got2, _ = zoo.decode_step(cfg, params,
                              torch.as_tensor(np.array(tok))[:, None].long(),
                              caches, S, enc_out=encdec.encode(cfg, params, e))
    _close(got2, want2, dtype)


def test_whisper_cached_prefill_ignores_the_encoder_as_the_reference_does(
        model):
    """ROADMAP queue 3, item 7: on the cached path cross K/V come from a
    zero-initialised cache that prefill never fills from the encoder
    output, so two different `enc_embeds` give the same logits, exactly, in
    both packages, and the cross caches stay zero; the uncached forward of
    the same inputs does tell the two apart."""
    dtype, rc, rparams, cfg, params, mesh = model
    jt, t = _tokens(cfg, S, 8)
    ref_logits, port_logits, ref_hidden, port_hidden = [], [], [], []
    for seed in (9, 10):
        je, e = _both(_embeds(cfg, seed), dtype)
        rcache = ref_init(ref_zoo.build_cache_specs(rc, B, MAX_LEN),
                          jax.random.PRNGKey(1))
        caches = init_from_specs(zoo.build_cache_specs(cfg, B, MAX_LEN), 0,
                                 device="cpu")
        with compat_set_mesh(mesh):
            lg, rcache = ref_zoo.prefill(
                rc, rparams, {"tokens": jt, "enc_embeds": je}, rcache,
                mesh=mesh)
            renc = ref_encdec.encode(rc, rparams, je, mesh=mesh)
            lg2, rcache = ref_zoo.decode_step(
                rc, rparams, jt[:, :1], rcache, jnp.int32(S), mesh=mesh,
                enc_out=renc)
            ref_hidden.append(np.asarray(ref_encdec.decode_stack(
                rc, rparams, jt, renc, mesh=mesh)[0], np.float32))
        ref_logits.append((np.asarray(lg), np.asarray(lg2)))
        assert not np.asarray(rcache["cross_k"]).any()
        got, caches = zoo.prefill(cfg, params,
                                  {"tokens": t, "enc_embeds": e}, caches)
        enc = encdec.encode(cfg, params, e)
        got2, caches = zoo.decode_step(cfg, params, t[:, :1], caches, S,
                                       enc_out=enc)
        port_logits.append((got, got2))
        assert not caches["cross_k"].any() and not caches["cross_v"].any()
        port_hidden.append(encdec.decode_stack(cfg, params, t, enc)[0])
    for step in range(2):
        assert np.array_equal(ref_logits[0][step], ref_logits[1][step])
        assert torch.equal(port_logits[0][step], port_logits[1][step])
    assert np.abs(ref_hidden[0] - ref_hidden[1]).max() > 0.05
    assert float((port_hidden[0] - port_hidden[1]).abs().max()) > 0.05


def test_serve_engine_fails_for_whisper_as_the_reference_does(model):
    """ROADMAP queue 3, item 8: the engine feeds `{"tokens": ...}` only, and
    the encoder-decoder's prefill needs `enc_embeds`, in both packages."""
    dtype, rc, rparams, cfg, params, mesh = model
    prompt = np.arange(1, 9)
    ref = RefServeEngine(rc, rparams, mesh=mesh, batch_slots=2, max_len=16,
                         prompt_len=8)
    from repro.serve.engine import Request as RefRequest
    with pytest.raises(KeyError, match="enc_embeds"):
        ref.run([RefRequest(prompt=prompt, max_new_tokens=2)])
    from repro_torch.serve.engine import Request
    engine = ServeEngine(cfg, params, batch_slots=2, max_len=16,
                         prompt_len=8, device="cpu")
    with pytest.raises(KeyError, match="enc_embeds"):
        engine.run([Request(prompt=prompt, max_new_tokens=2)])
