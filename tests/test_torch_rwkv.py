"""The port's RWKV6 layer (`repro_torch.models.rwkv`) and its scan wrapper
(`repro_torch.kernels.rwkv6_scan`, plain version on CPU tensors) against
the JAX package's, on the same numpy-made inputs.

Twins of `tests/test_models.py:127-143` (chunked form against the per-token
oracle, at its 1e-4) and `tests/test_kernels.py:97-109` (the WKV op at its
2e-4), each with and without an initial state; the port's chunked form and
oracle are also held against the reference's own at 2e-5.  The time mix
(prefill then a decode step, carrying state and token shift) and the
channel mix run on weights carried across from the reference, in float32
at 2e-5 and bfloat16 at 2e-2 (the reference's kernel tolerances).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import TOL, normal

from repro.kernels import ops as ref_ops
from repro.models import rwkv as ref_rwkv
from repro.models.module import init_from_specs as ref_init

from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models import rwkv


def _inputs(B, S, H, K, V, seed=0):
    """r, k, v, logw (-softplus - 0.5), u and an initial state, as numpy
    float32 arrays."""
    logw = -np.log1p(np.exp(normal((B, S, H, K), seed + 3))) - 0.5
    return (normal((B, S, H, K), seed), normal((B, S, H, K), seed + 1),
            normal((B, S, H, V), seed + 2), logw.astype(np.float32),
            normal((H, K), seed + 4, 0.1), normal((B, H, K, V), seed + 5, 0.5))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@pytest.mark.parametrize("init", [False, True])
def test_rwkv6_chunked_matches_oracles_and_reference(init):
    *args, s0 = _inputs(2, 64, 2, 16, 16)
    s0 = s0 if init else None
    t = [torch.as_tensor(a) for a in args]
    ts0 = None if s0 is None else torch.as_tensor(s0)
    o1, s1 = rwkv.rwkv6_chunked(*t, chunk=16, initial_state=ts0)
    o2, s2 = rwkv.rwkv6_scan_oracle(*t, initial_state=ts0)
    for got, want in ((o1, o2), (s1, s2)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    j = [jnp.asarray(a) for a in args]
    js0 = None if s0 is None else jnp.asarray(s0)
    ro, rs = ref_rwkv.rwkv6_chunked(*j, chunk=16, initial_state=js0)
    oo, os_ = ref_rwkv.rwkv6_scan_oracle(*j, initial_state=js0)
    for got, want in ((o1, ro), (s1, rs), (o2, oo), (s2, os_)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("B,S,H,K,V,chunk", [
    (1, 32, 1, 8, 8, 8), (2, 64, 3, 16, 16, 16), (1, 96, 2, 32, 16, 32),
])
def test_rwkv6_wkv_op_matches_reference(B, S, H, K, V, chunk):
    *args, _ = _inputs(B, S, H, K, V, seed=B + S)
    got = ops.rwkv6_wkv(*[torch.as_tensor(a) for a in args], chunk=chunk)
    want = ref_ops.rwkv6_wkv(*[jnp.asarray(a) for a in args], chunk=chunk,
                             interpret=True)
    assert got.shape == (B, S, H, V) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_logw_is_clipped_to_logw_min():
    # decays below exp(-6) a step act as exp(-6), in every form
    r, k, v, logw, u, s0 = _inputs(1, 32, 2, 8, 8, seed=4)
    deep = logw.copy()
    deep[:, ::3] = -40.0
    clipped = np.maximum(deep, rwkv.LOGW_MIN)
    assert rwkv.LOGW_MIN == ref_rwkv.LOGW_MIN == -6.0
    t = [torch.as_tensor(a) for a in (r, k, v)]
    for fn in (lambda w: rwkv.rwkv6_chunked(*t, w, torch.as_tensor(u),
                                            chunk=8),
               lambda w: rwkv.rwkv6_scan_oracle(*t, w, torch.as_tensor(u)),
               lambda w: rwkv6_scan(*t, w, torch.as_tensor(u), chunk=8)):
        a, b = fn(torch.as_tensor(deep)), fn(torch.as_tensor(clipped))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    o, _ = rwkv.rwkv6_chunked(*t, torch.as_tensor(deep), torch.as_tensor(u),
                              chunk=8)
    want, _ = ref_rwkv.rwkv6_chunked(*[jnp.asarray(a) for a in (r, k, v)],
                                     jnp.asarray(deep), jnp.asarray(u),
                                     chunk=8)
    np.testing.assert_allclose(_np(o), _np(want), **TOL["float32"])
    # one decode step clips the same way
    st = torch.as_tensor(s0)
    a = rwkv.rwkv6_decode_step(st, *[x[:, :1] for x in t],
                               torch.as_tensor(deep[:, :1]),
                               torch.as_tensor(u))
    b = rwkv.rwkv6_decode_step(st, *[x[:, :1] for x in t],
                               torch.as_tensor(clipped[:, :1]),
                               torch.as_tensor(u))
    assert torch.equal(a[1], b[1])


def test_rwkv6_scan_wrapper_carries_the_state():
    *args, s0 = _inputs(2, 64, 3, 16, 8, seed=7)
    r, k, v, logw, u = (torch.as_tensor(a) for a in args)
    o, s = rwkv6_scan(r, k, v, logw, u, chunk=16,
                      initial_state=torch.as_tensor(s0))
    half = [x[:, :32] for x in (r, k, v, logw)]
    rest = [x[:, 32:] for x in (r, k, v, logw)]
    oa, sa = rwkv6_scan(*half, u, chunk=16, initial_state=torch.as_tensor(s0))
    ob, sb = rwkv6_scan(*rest, u, chunk=16, initial_state=sa)
    np.testing.assert_allclose(_np(torch.cat([oa, ob], 1)), _np(o),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(sb), _np(s), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        rwkv6_scan(*[x[:, :40] for x in (r, k, v, logw)], u, chunk=16)


def _carried(dtype, seed):
    jd = getattr(jnp, dtype)
    specs = ref_rwkv.rwkv6_specs(64, head_dim=16, d_ff=96, dtype=jd)
    rp = ref_init(specs, jax.random.PRNGKey(seed))
    # the init zeroes the mixing rates, the decay bias and the bonus: give
    # them values so that every term of the layer is exercised
    tm = dict(rp["tm"], u=jnp.asarray(normal((4, 16), 20, 0.3)),
              w_bias=jnp.asarray(normal((64,), 21)))
    for i, mu in enumerate(("mu_r", "mu_k", "mu_v", "mu_w", "mu_g")):
        tm[mu] = jnp.asarray(np.abs(normal((64,), 22 + i, 0.5))).astype(jd)
    cm = dict(rp["cm"], mu_k=jnp.asarray(
        np.abs(normal((64,), 30, 0.5))).astype(jd))
    rp = {"tm": tm, "cm": cm}
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_prefill_then_decode_matches_reference(dtype):
    rp, p = _carried(dtype, 5)
    x = normal((2, 17, 64), 11)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    ry, (rs, rl) = ref_rwkv.rwkv6_time_mix(rp["tm"], jx[:, :16], head_dim=16,
                                           chunk=8)
    ry1, (rs1, rl1) = ref_rwkv.rwkv6_time_mix(rp["tm"], jx[:, 16:],
                                              head_dim=16, state=rs,
                                              last_x=rl)
    py, (ps, pl) = rwkv.rwkv6_time_mix(p["tm"], tx[:, :16], head_dim=16,
                                       chunk=8)
    py1, (ps1, pl1) = rwkv.rwkv6_time_mix(p["tm"], tx[:, 16:], head_dim=16,
                                          state=ps, last_x=pl)
    assert torch.equal(pl, tx[:, 15]) and torch.equal(pl1, tx[:, 16])
    for got, want in ((py, ry), (py1, ry1), (ps, rs), (ps1, rs1)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_reference(dtype):
    rp, p = _carried(dtype, 6)
    x = normal((2, 9, 64), 12)
    last = normal((2, 64), 13)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for lx in (None, last):
        ry, rl = ref_rwkv.rwkv6_channel_mix(
            rp["cm"], jnp.asarray(x).astype(jd),
            None if lx is None else jnp.asarray(lx).astype(jd))
        py, pl = rwkv.rwkv6_channel_mix(
            p["cm"], torch.as_tensor(x).to(td),
            None if lx is None else torch.as_tensor(lx).to(td))
        np.testing.assert_allclose(_np(py), _np(ry), **TOL[dtype])
        assert np.array_equal(_np(pl), _np(rl))
