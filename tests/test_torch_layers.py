"""The port's model layers (`repro_torch.models.layers`, plain path) against
the JAX package's (`repro.models.layers`) on the same numpy-made inputs.

Tolerances: float32 at rtol/atol 1e-5 — both sides compute the same
float32 arithmetic, and only the order of sums (einsum, mean) differs, a
few ulps; bfloat16 at 2e-2 (the reference's own bf16 kernel tolerance) —
the two frameworks round bf16 intermediates at slightly different places
(elementwise silu/gelu, matmul outputs), each at most one bf16 ulp (2^-8
relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import normal

from repro.models import layers as ref

from repro_torch.models import layers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.as_tensor(a).to(td)


def _check(got, want, dtype):
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(dtype):
    jx, x = _pair(normal((2, 7, 64), 0), dtype)
    js, s = _pair(normal((64,), 1), dtype)
    jb, b = _pair(normal((64,), 2), dtype)
    _check(layers.rmsnorm(x, s), ref.rmsnorm(jx, js), dtype)
    _check(layers.layernorm(x, s, b), ref.layernorm(jx, js, jb), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope(dtype, theta):
    jx, x = _pair(normal((2, 11, 3, 32), 3), dtype)
    pos = np.broadcast_to(np.arange(5, 16), (2, 11)).copy()
    got = layers.apply_rope(x, torch.as_tensor(pos), theta)
    _check(got, ref.apply_rope(jx, jnp.asarray(pos, jnp.int32), theta), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,Hq,Hkv,bq,bk", [
    (40, 6, 2, 16, 16),     # GQA, ragged S against blocks of 16
    (64, 4, 4, 16, 32),     # MHA, whole blocks
    (24, 4, 1, 512, 1024),  # MQA, one block each way
])
@pytest.mark.parametrize("causal", [True, False])
def test_blocked_attention(dtype, S, Hq, Hkv, bq, bk, causal):
    jq, q = _pair(normal((2, S, Hq, 16), 4), dtype)
    jk, k = _pair(normal((2, S, Hkv, 16), 5), dtype)
    jv, v = _pair(normal((2, S, Hkv, 16), 6), dtype)
    got = layers.blocked_attention(q, k, v, causal=causal, block_q=bq,
                                   block_kv=bk)
    want = ref.blocked_attention(jq, jk, jv, causal=causal, block_q=bq,
                                 block_kv=bk)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cur_len", [1, 17, 40])
def test_decode_attention(dtype, cur_len):
    jq, q = _pair(normal((2, 1, 6, 32), 7), dtype)
    jk, k = _pair(normal((2, 40, 2, 32), 8), dtype)
    jv, v = _pair(normal((2, 40, 2, 32), 9), dtype)
    _check(layers.decode_attention(q, k, v, cur_len),
           ref.decode_attention(jq, jk, jv, cur_len), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlps(dtype):
    jx, x = _pair(normal((2, 5, 32), 10), dtype)
    glu = {n: _pair(normal(shape, 11 + i, 0.2), dtype) for i, (n, shape) in
           enumerate((("gate", (32, 48)), ("up", (32, 48)),
                      ("down", (48, 32))))}
    _check(layers.glu_mlp({n: t for n, (_, t) in glu.items()}, x),
           ref.glu_mlp({n: j for n, (j, _) in glu.items()}, jx), dtype)
    gelu = {n: _pair(normal(shape, 20 + i, 0.2), dtype) for i, (n, shape) in
            enumerate((("in", (32, 48)), ("in_b", (48,)),
                       ("out", (48, 32)), ("out_b", (32,))))}
    _check(layers.gelu_mlp({n: t for n, (_, t) in gelu.items()}, x),
           ref.gelu_mlp({n: j for n, (j, _) in gelu.items()}, jx), dtype)


def test_mrope_sections_rotate_independently():
    """Twin of the reference's test of the same name: three equal streams
    are plain RoPE (rtol = atol = 1e-5), and a stream of its own changes
    the result."""
    B, S, H, D = 1, 8, 2, 32
    x = torch.as_tensor(normal((B, S, H, D), 0))
    pos = torch.arange(S)[None].expand(B, S)
    same = layers.apply_mrope(x, torch.stack([pos, pos, pos]),
                              sections=(8, 4, 4), theta=1e4)
    plain = layers.apply_rope(x, pos, theta=1e4)
    np.testing.assert_allclose(same.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    diff = layers.apply_mrope(x, torch.stack([pos, pos * 2, pos]),
                              sections=(8, 4, 4), theta=1e4)
    assert not np.allclose(diff.numpy(), plain.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections,theta", [((8, 4, 4), 1e4),
                                            ((4, 6, 6), 1e6)])
def test_apply_mrope_matches_the_reference(dtype, sections, theta):
    """Three different position streams (t, h, w), as a vision prompt
    gives: each section of slots turns by its own stream."""
    jx, x = _pair(normal((2, 11, 3, 32), 30), dtype)
    rng = np.random.default_rng(31)
    pos = np.stack([np.broadcast_to(np.arange(11), (2, 11)),
                    rng.integers(0, 40, (2, 11)),
                    rng.integers(0, 40, (2, 11))])
    got = layers.apply_mrope(x, torch.as_tensor(pos), sections, theta)
    _check(got, ref.apply_mrope(jx, jnp.asarray(pos, jnp.int32), sections,
                                theta), dtype)
    with pytest.raises(ValueError, match="head_dim"):
        layers.apply_mrope(x, torch.as_tensor(pos), (8, 8, 8), theta)
