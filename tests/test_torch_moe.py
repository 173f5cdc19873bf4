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

The capacity path's slot-table dispatch and combine against a test-local
oracle, the accumulating scatter they replaced (`_accumulating_moe`, the
reference's `.at[].add` onto zeros): the forward equal bit for bit, the
gradients to the order of the top_k sum, and no accumulating op on rows.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _torch_inputs import TOL, normal
from torch.utils._python_dispatch import TorchDispatchMode

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


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_moe_slot_counts_equal_bincount(monkeypatch, impl):
    """The per-expert slot counts come from a static-shape scatter-add of
    ones (the reference's `zeros((E,)).at[flat_e].add(1)`), in place of
    `torch.bincount`, whose output shape depends on the data (a
    fake-tensor dry run cannot give it).  The integers are bincount's, so
    the aux loss and the ragged path's groups are bit for bit the values
    before."""
    _, params = _carried("float32")
    x = torch.as_tensor(normal((2, 8, 32), 7))
    groups = []
    ragged_dot = layers._ragged_dot

    def recording(xs, w, group_sizes):
        groups.append(group_sizes)
        return ragged_dot(xs, w, group_sizes)

    monkeypatch.setattr(layers, "_ragged_dot", recording)
    _, aux = layers.moe_ffn(params, x, top_k=2, impl=impl)
    probs = torch.softmax(x.reshape(-1, 32).float() @ params["router"], -1)
    flat_e = torch.topk(probs, 2, dim=-1).indices.reshape(-1)
    counts = torch.bincount(flat_e, minlength=8)
    frac = counts.float() / flat_e.numel()
    assert torch.equal(aux, 8 * torch.sum(frac * probs.mean(dim=0)))
    assert len(groups) == (3 if impl == "ragged" else 0)
    assert all(torch.equal(g, counts) for g in groups)


def _accumulating_moe(params, x, *, top_k, capacity_factor):
    """The capacity path as it was before the slot table: every (token, k)
    row scattered with `index_put_(accumulate=True)` onto its expert slot,
    a dropped row clamped onto slot C - 1 as a row of zeros; the combine
    an advanced-index gather, whose backward accumulates the same way."""
    B, S, D = x.shape
    E = params["router"].shape[1]
    n = B * S
    xf = x.reshape(n, D)
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)
    topv, topi = torch.topk(probs, top_k, dim=-1)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    flat_e = topi.reshape(-1)
    group_sizes = torch.zeros(E, dtype=torch.int64).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    w_slot = topv.reshape(-1).float()
    C = max(8, int(math.ceil(n * top_k * capacity_factor / E)))
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(n * top_k)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool),
                          sorted_e[1:] != sorted_e[:-1]])
    group_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    rank = torch.empty_like(flat_e)
    rank[order] = idx - group_start
    ok = rank < C
    rank_c = torch.clamp_max(rank, C - 1)
    contrib = torch.where(ok[:, None], xf[idx // top_k], 0)
    buf = xf.new_zeros((E, C, D)).index_put_((flat_e, rank_c), contrib,
                                             accumulate=True)
    gemm = functools.partial(torch.einsum, "ecd,edf->ecf")
    y_buf = gemm(F.silu(gemm(buf, params["gate"])) *
                 gemm(buf, params["up"]), params["down"])
    y = y_buf[flat_e, rank_c] * ok.to(y_buf.dtype)[:, None]
    out = torch.sum((y.float() * w_slot[:, None]).reshape(n, top_k, D),
                    dim=1)
    if "shared" in params:
        sp = params["shared"]
        hs = F.silu(xf @ sp["gate"]) * (xf @ sp["up"])
        out = out + (hs @ sp["down"]).float()
    aux = E * torch.sum(group_sizes.float() / (n * top_k) *
                        probs.mean(dim=0))
    return out.to(x.dtype).reshape(B, S, D), aux, int((~ok).sum()), C


def _dispatch_case(case, dtype):
    """(params, x, top_k, cf) of a named case: capacity factors 1.25 and
    0.5 on varied tokens; one token repeated 64 times (its two experts
    hold 64 rows each against C at its floor of 8); and one token
    repeated with top_k 1, every row to one expert."""
    _, p = _carried(dtype)
    td = getattr(torch, dtype)
    if case in ("cf1.25", "cf0.5"):
        x = torch.as_tensor(normal((4, 16, 32), 2))
        return p, x.to(td), 2, float(case[2:])
    x = torch.as_tensor(normal((1, 1, 32), 5)).expand(2, 32, 32)
    if case == "floor":
        return p, x.to(td), 2, 0.5
    return p, x.to(td), 1, 1.25


CASES = ["cf1.25", "cf0.5", "floor", "one_expert"]
LEAVES = ("router", "gate", "up", "down")


def _grads(fn, p, x):
    """`fn`'s output, aux and the gradients of a fixed projection of both
    with respect to x and the router and expert weights."""
    p = {k: (v.detach().clone().requires_grad_(True) if k in LEAVES else v)
         for k, v in p.items()}
    x = x.detach().clone().requires_grad_(True)
    out, aux = fn(p, x)[:2]
    g = torch.Generator().manual_seed(9)
    proj = torch.randn(out.shape, generator=g).to(out.dtype)
    (torch.sum(out.float() * proj.float()) + aux).backward()
    return out, aux, [x.grad] + [p[k].grad for k in LEAVES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_slot_table_forward_equals_the_accumulating_scatter(case, dtype):
    p, x, k, cf = _dispatch_case(case, dtype)
    want, want_aux, dropped, C = _accumulating_moe(p, x, top_k=k,
                                                   capacity_factor=cf)
    got, aux = layers.moe_ffn(p, x, top_k=k, capacity_factor=cf)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    n = x.shape[0] * x.shape[1]
    if case == "floor":
        assert C == 8 and dropped == k * (n - C)
    if case == "one_expert":
        assert dropped == n - C > n // 2
    if case == "cf0.5":
        assert dropped > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_slot_table_gradients_match_the_accumulating_scatter(case, dtype):
    """x's gradient sums the top_k rows in float32 (the oracle in x's
    dtype, one add a row), so float32 agrees to 1e-6 of each tensor's
    largest magnitude and bfloat16 at the file's tolerance; the router's
    and the experts' gradients follow the same slots."""
    p, x, k, cf = _dispatch_case(case, dtype)
    kw = dict(top_k=k, capacity_factor=cf)
    out, aux, got = _grads(lambda q, y: layers.moe_ffn(q, y, **kw), p, x)
    want_out, want_aux, want = _grads(
        lambda q, y: _accumulating_moe(q, y, **kw), p, x)
    assert torch.equal(out, want_out) and torch.equal(aux, want_aux)
    for name, a, b in zip(("x",) + LEAVES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if dtype == "float32":
            scale = float(b.abs().max())
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                       atol=1e-6 * scale, err_msg=name)
        else:
            np.testing.assert_allclose(_np(a), _np(b), **TOL[dtype],
                                       err_msg=name)


class _Accumulations(TorchDispatchMode):
    """The accumulating scatters dispatched onto tensors of two or more
    dimensions (rows): `index_put` with accumulate, `index_add`,
    `scatter_add`, `scatter_reduce`."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        accumulates = (
            name in ("index_add", "index_add_", "scatter_add",
                     "scatter_add_", "scatter_reduce", "scatter_reduce_")
            or (name in ("index_put", "index_put_", "_index_put_impl_")
                and (args[3] if len(args) > 3
                     else kwargs.get("accumulate", False))))
        if accumulates and args[0].dim() >= 2:
            self.found.append((name, tuple(args[0].shape)))
        return func(*args, **kwargs)


@pytest.mark.parametrize("case", ["cf1.25", "floor"])
def test_capacity_path_accumulates_no_rows(case):
    """Forward and backward of the capacity path dispatch no accumulating
    scatter onto rows (the per-expert counts' `index_add_` is over a 1-D
    tensor); the oracle, run the same way, is caught."""
    p, x, k, cf = _dispatch_case(case, "float32")
    kw = dict(top_k=k, capacity_factor=cf)
    with _Accumulations() as mode:
        _grads(lambda q, y: layers.moe_ffn(q, y, **kw), p, x)
    assert mode.found == []
    with _Accumulations() as oracle:
        _grads(lambda q, y: _accumulating_moe(q, y, **kw), p, x)
    assert {name for name, _ in oracle.found} >= {"index_put_"}
