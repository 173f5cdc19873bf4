"""The serving kernels' plain PyTorch versions (what the port's wrappers run
on CPU tensors) against the JAX package's oracles (`repro.kernels.ref`) and
its Pallas kernels in interpret mode (`repro.kernels.ops`), on the shapes of
`tests/test_kernels.py` and at its tolerances (float32 2e-5, bfloat16
2e-2: both sides compute in float32 and round the output once, so the
bfloat16 tolerance covers one rounding of the output).

Flash attention is swept against the reference's oracle at S = T only: for
S != T the reference's kernel and oracle align the causal mask differently
(ROADMAP queue 3, item 2).  There the port aligns it top-left, as the
reference's kernel and model layer do, and is held against both.  The last
tests hold the
wrappers' grouped-KV (GQA) form, on the model's strided layouts, against the
JAX model layers each kernel replaces on the serving path; there the
bfloat16 tolerance also covers the one rounding (of p, or of the norm
before its scale) in which the kernels' functions differ from the layers'.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import TOL, normal

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import layers as ref_layers

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_fwd

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """The same numpy values as a JAX array and a torch CPU tensor."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.as_tensor(a).to(td)


def _check(got, want_jax, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want_jax, np.float32), **TOL[dtype])


@pytest.mark.parametrize("B,H,S,D,bq,bk", [
    (1, 1, 64, 32, 16, 16), (2, 3, 128, 64, 32, 64),
    (1, 2, 256, 128, 64, 32), (2, 1, 96, 16, 32, 48),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_reference(B, H, S, D, bq, bk, dtype,
                                                 causal):
    (jq, q), (jk, k), (jv, v) = (_pair(normal((B, H, S, D), i), dtype)
                                 for i in range(3))
    got = ops.flash_attention(q, k, v, causal=causal, block_q=bq,
                              block_kv=bk)
    assert got.dtype == q.dtype and got.shape == q.shape
    _check(got, ref_ref.flash_attention_ref(jq, jk, jv, causal=causal),
           dtype)
    _check(got, ref_ops.flash_attention(jq, jk, jv, causal=causal,
                                        block_q=bq, block_kv=bk,
                                        interpret=True), dtype)


@pytest.mark.parametrize("B,H,T,D,bk,cur", [
    (2, 4, 128, 64, 32, 100), (1, 2, 256, 32, 64, 1),
    (3, 1, 64, 128, 16, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_reference(B, H, T, D, bk, cur,
                                                  dtype):
    jq, q = _pair(normal((B, H, D), 0), dtype)
    jk, k = _pair(normal((B, H, T, D), 1), dtype)
    jv, v = _pair(normal((B, H, T, D), 2), dtype)
    got = ops.decode_attention(q, k, v, cur, block_kv=bk)
    assert got.dtype == q.dtype and got.shape == q.shape
    _check(got, ref_ref.decode_attention_ref(jq, jk, jv, cur), dtype)
    _check(got, ref_ops.decode_attention(jq, jk, jv, jnp.int32(cur),
                                         block_kv=bk, interpret=True), dtype)


@pytest.mark.parametrize("shape,br", [((4, 37, 96), 16), ((2, 8, 128), 8),
                                      ((1, 300, 64), 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_reference(shape, br, dtype):
    jx, x = _pair(normal(shape, 0), dtype)
    js, s = _pair(normal(shape[-1:], 1), "float32")
    got = ops.rmsnorm(x, s, block_rows=br)
    assert got.dtype == x.dtype and got.shape == x.shape
    _check(got, ref_ref.rmsnorm_ref(jx, js), dtype)
    _check(got, ref_ops.rmsnorm(jx, js, block_rows=br, interpret=True),
           dtype)


@pytest.mark.parametrize("S,T,bq,bk", [(32, 64, 16, 16), (64, 32, 16, 16),
                                       (64, 128, 32, 64), (128, 64, 64, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_flash_s_not_t_matches_the_kernel_and_blocked_attention(
        S, T, bq, bk, dtype):
    # top-left: query i sees keys j <= i, so for S > T the rows i >= T see
    # every key; S and T are multiples of the Pallas kernel's blocks
    jq, q = _pair(normal((2, 3, S, 32), 0), dtype)
    jk, k = _pair(normal((2, 3, T, 32), 1), dtype)
    jv, v = _pair(normal((2, 3, T, 32), 2), dtype)
    got = ops.flash_attention(q, k, v, causal=True, block_q=bq, block_kv=bk)
    assert got.dtype == q.dtype and got.shape == q.shape
    _check(got, ref_ops.flash_attention(jq, jk, jv, causal=True, block_q=bq,
                                        block_kv=bk, interpret=True), dtype)
    want = ref_layers.blocked_attention(
        *(a.transpose(0, 2, 1, 3) for a in (jq, jk, jv)), causal=True,
        block_q=bq, block_kv=bk)
    _check(got.transpose(1, 2), want, dtype)


# ---- the strided GQA form, against the model layers it replaces ----------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_flash_plain_matches_blocked_attention(dtype, causal):
    # the model's (B, S, H, D) layout as transposed views, 6 query heads
    # over 2 KV heads, ragged S = 40 against blocks of 16
    jq, q = _pair(normal((2, 40, 6, 32), 0), dtype)
    jk, k = _pair(normal((2, 40, 2, 32), 1), dtype)
    jv, v = _pair(normal((2, 40, 2, 32), 2), dtype)
    got = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
    want = ref_layers.blocked_attention(jq, jk, jv, causal=causal,
                                        block_q=16, block_kv=16)
    _check(got.transpose(1, 2), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cur_len", [1, 23, 48])
def test_gqa_decode_plain_matches_decode_attention(dtype, cur_len):
    jq, q = _pair(normal((3, 1, 6, 32), 3), dtype)
    jk, k = _pair(normal((3, 48, 2, 32), 4), dtype)
    jv, v = _pair(normal((3, 48, 2, 32), 5), dtype)
    got = decode_attention_fwd(q[:, 0], k.transpose(1, 2),
                               v.transpose(1, 2), cur_len)
    want = ref_layers.decode_attention(jq, jk, jv, cur_len)
    _check(got[:, None], want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_model_rmsnorm(dtype):
    jx, x = _pair(normal((2, 9, 128), 6), dtype)
    js, s = _pair(normal((128,), 7), dtype)
    _check(rmsnorm_fwd(x, s), ref_layers.rmsnorm(jx, js), dtype)
