"""The port's fine-grained MoE FFN (`repro_torch.models.layers.moe_ffn`) and
grouped expert GEMM (`repro_torch.kernels.ops.grouped_expert_gemm`, plain
version on CPU tensors) against the JAX package's.

`moe_ffn` runs on parameters initialised in the reference and carried
across, against the reference's on a (1, 1) mesh with
`dp_axes=("data",)`: both the capacity path and the ragged twin, in float32
at 2e-5 and bfloat16 at 2e-2 (the reference's kernel tolerances), with the
load-balance aux loss at 1e-6.  A capacity factor of 0.5 makes experts
overflow, so the same tokens must be dropped: the stable rank within an
expert decides which.  The GEMM sweep is `tests/test_kernels.py:53-67` at
its tolerances (float32 1e-4, bfloat16 5e-2).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import TOL, normal

from repro.kernels import ops as ref_ops
from repro.launch.mesh import compat_make_mesh, compat_set_mesh
from repro.models import layers as ref_layers
from repro.models.module import init_from_specs as ref_init

from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.module import init_from_specs


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _carried(dtype, n_shared=1, seed=0):
    jd = getattr(jnp, dtype)
    specs = ref_layers.moe_specs(32, 24, n_routed=8, n_shared=n_shared,
                                 dtype=jd)
    rp = ref_init(specs, jax.random.PRNGKey(seed))
    # a router of the spec's scale 0.02 gives near-uniform probabilities;
    # a wider one makes the top-k choice and the renormalised weights count
    rp = dict(rp, router=jnp.asarray(normal((32, 8), seed + 1, 0.5)))
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _ref_moe(rp, x, **kw):
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    fn = jax.jit(functools.partial(ref_layers.moe_ffn, mesh=mesh,
                                   dp_axes=("data",), **kw))
    with compat_set_mesh(mesh):
        return fn(rp, x)


@pytest.mark.parametrize("impl,cf", [("capacity", 1.25), ("capacity", 0.5),
                                     ("ragged", 1.25)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(impl, cf, dtype):
    rp, p = _carried(dtype)
    x = normal((4, 16, 32), 2)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    want, want_aux = _ref_moe(rp, jx, top_k=2, impl=impl, capacity_factor=cf)
    got, aux = layers.moe_ffn(p, tx, top_k=2, impl=impl, capacity_factor=cf)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    if cf < 1:   # 128 (token, slot) pairs over 8 slots in each of 8 experts
        exact, _ = layers.moe_ffn(p, tx, top_k=2, impl="ragged")
        assert not np.allclose(_np(got), _np(exact), **TOL[dtype])


def test_moe_capacity_matches_dense_when_unconstrained():
    """With generous capacity, the capacity MoE == the exact ragged twin."""
    specs = layers.moe_specs(16, 8, n_routed=8, n_shared=1,
                             dtype=torch.float32)
    params = init_from_specs(specs, 0, device="cpu")
    x = torch.as_tensor(normal((4, 8, 16), 2))
    out_cap, aux_cap = layers.moe_ffn(params, x, top_k=2, impl="capacity",
                                      capacity_factor=8.0)
    out_rag, aux_rag = layers.moe_ffn(params, x, top_k=2, impl="ragged")
    np.testing.assert_allclose(_np(out_cap), _np(out_rag), rtol=1e-4,
                               atol=1e-4)
    assert float(aux_cap) == float(aux_rag)


def test_moe_ffn_without_shared_experts_and_unknown_impl():
    rp, p = _carried("float32", n_shared=0, seed=3)
    assert "shared" not in p
    x = normal((2, 5, 32), 4)
    want, _ = _ref_moe(rp, jnp.asarray(x), top_k=3)
    got, _ = layers.moe_ffn(p, torch.as_tensor(x), top_k=3)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    with pytest.raises(ValueError, match="unknown MoE impl"):
        layers.moe_ffn(p, torch.as_tensor(x), top_k=3, impl="dense")
    with pytest.raises(ValueError, match="has no kernel"):
        layers.moe_ffn(p, torch.as_tensor(x), top_k=3, impl="ragged",
                       kernels=True)


@pytest.mark.parametrize("E,C,K,N,bm,bn,bkk", [
    (2, 32, 64, 48, 16, 16, 32), (4, 64, 96, 80, 32, 16, 32),
    (1, 128, 128, 128, 128, 128, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_expert_gemm_matches_reference(E, C, K, N, bm, bn, bkk,
                                               dtype):
    x, w = normal((E, C, K), 0, 0.3), normal((E, K, N), 1, 0.3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = ops.grouped_expert_gemm(torch.as_tensor(x).to(td),
                                  torch.as_tensor(w).to(td), block_m=bm,
                                  block_n=bn, block_k=bkk)
    want = ref_ops.grouped_expert_gemm(jnp.asarray(x).astype(jd),
                                       jnp.asarray(w).astype(jd),
                                       block_m=bm, block_n=bn, block_k=bkk,
                                       interpret=True)
    assert got.dtype == td and got.shape == (E, C, N)
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
