"""The port's Mamba2 / SSD layer (`repro_torch.models.ssm`) and its scan
wrapper (`repro_torch.kernels.ssd_scan`, plain version on CPU tensors)
against the JAX package's, on the same numpy-made inputs.

Twins of `tests/test_models.py:110-125` (chunked form against the per-token
oracle, at its 1e-4) and `tests/test_kernels.py:82-94` (the scan op at its
2e-4), each with and without an initial state; the port's chunked form and
oracle are also held against the reference's own at 2e-5 (the same float32
arithmetic, sums in another order).  `mamba2_block` runs a prefill then a
decode step on weights carried across from the reference, in float32 at
2e-5 and bfloat16 at 2e-2 (the reference's kernel tolerances).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import TOL, normal

from repro.kernels import ops as ref_ops
from repro.models import ssm as ref_ssm
from repro.models.module import init_from_specs as ref_init

from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import ssm


def _inputs(B, S, H, P, N, seed=0):
    """x, dt (softplus of normals), A (-exp of normals/2), B, C and an
    initial state, as numpy float32 arrays."""
    x = normal((B, S, H, P), seed)
    dt = np.log1p(np.exp(normal((B, S, H), seed + 1)))
    A = -np.exp(normal((H,), seed + 2, 0.5))
    return (x, dt, A, normal((B, S, N), seed + 3), normal((B, S, N), seed + 4),
            normal((B, H, P, N), seed + 5, 0.5))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_oracles_and_reference(init):
    *args, s0 = _inputs(2, 96, 3, 16, 8)
    s0 = s0 if init else None
    t = [torch.as_tensor(a) for a in args]
    y1, s1 = ssm.ssd_chunked(*t, chunk=32, initial_state=None if s0 is None
                             else torch.as_tensor(s0))
    y2, s2 = ssm.ssd_scan_oracle(*t, initial_state=None if s0 is None
                                 else torch.as_tensor(s0))
    for got, want in ((y1, y2), (s1, s2)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    j = [jnp.asarray(a) for a in args]
    js0 = None if s0 is None else jnp.asarray(s0)
    ry, rs = ref_ssm.ssd_chunked(*j, chunk=32, initial_state=js0)
    oy, os_ = ref_ssm.ssd_scan_oracle(*j, initial_state=js0)
    for got, want in ((y1, ry), (s1, rs), (y2, oy), (s2, os_)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 32, 1, 8, 4, 8), (2, 64, 3, 16, 8, 16), (1, 128, 2, 32, 16, 32),
])
def test_mamba2_ssd_op_matches_reference(B, S, H, P, N, chunk):
    *args, _ = _inputs(B, S, H, P, N, seed=B + S)
    got = ops.mamba2_ssd(*[torch.as_tensor(a) for a in args], chunk=chunk)
    want = ref_ops.mamba2_ssd(*[jnp.asarray(a) for a in args], chunk=chunk,
                              interpret=True)
    assert got.shape == (B, S, H, P) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_ssd_scan_wrapper_carries_the_state():
    # two halves from the carried state equal one pass over the whole
    *args, s0 = _inputs(2, 64, 3, 16, 8, seed=7)
    t = [torch.as_tensor(a) for a in args]
    x, dt, A, Bm, Cm = t
    y, s = ssd_scan(x, dt, A, Bm, Cm, chunk=16,
                    initial_state=torch.as_tensor(s0))
    ya, sa = ssd_scan(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32],
                      chunk=16, initial_state=torch.as_tensor(s0))
    yb, sb = ssd_scan(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:],
                      chunk=16, initial_state=sa)
    np.testing.assert_allclose(_np(torch.cat([ya, yb], 1)), _np(y),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(sb), _np(s), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(x[:, :40], dt[:, :40], A, Bm[:, :40], Cm[:, :40], chunk=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_prefill_then_decode_matches_reference(dtype):
    jd = getattr(jnp, dtype)
    specs = ref_ssm.mamba2_specs(64, d_state=16, headdim=16, dtype=jd)
    rp = ref_init(specs, jax.random.PRNGKey(3))
    rp = dict(rp, A_log=jnp.asarray(normal((8,), 8, 0.5)),
              dt_bias=jnp.asarray(normal((8,), 9, 0.5)))
    p = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    x = normal((2, 17, 64), 10)
    jx = jnp.asarray(x).astype(jd)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    kw = dict(d_state=16, headdim=16, chunk=8)
    # prefill of 16 tokens from zero state, then one decode step
    ry, (rs, rc) = ref_ssm.mamba2_block(rp, jx[:, :16], **kw)
    ry1, (rs1, rc1) = ref_ssm.mamba2_block(rp, jx[:, 16:], state=rs,
                                           conv_state=rc, **kw)
    py, (ps, pc) = ssm.mamba2_block(p, tx[:, :16], **kw)
    py1, (ps1, pc1) = ssm.mamba2_block(p, tx[:, 16:], state=ps,
                                       conv_state=pc, **kw)
    for got, want in ((py, ry), (py1, ry1), (pc1, rc1)):
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    for got, want in ((ps, rs), (ps1, rs1)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
