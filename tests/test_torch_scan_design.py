"""The mathematics of the two tiled scan kernels, on the CPU.

`csrc/ssd_scan.cu:ssd_scan_kernel_tiled` and
`csrc/rwkv6_scan.cu:rwkv6_scan_kernel_tiled` run only on the card.  Here a
plain-torch mirror of each decomposition is held against the port's plain
versions (`ssd_scan_ref`, `rwkv6_scan_ref`, the per-token recurrences) and
against the JAX package's Pallas kernels in interpret mode, in float32 at
the scans' 2e-4 (`repro_torch.kernels.ref.SCAN_TOL`, `STATE_TOL`):

- ssd_scan split into slabs of P, each slab's y and state from the score
  tile C B^T computed once per (b, chunk) and decayed per head;
- rwkv6_scan split into slabs of V, with the score tile's exponentials
  factored by query sub-chunk (r e^(cum_ex - ref_I) against
  k e^(ref_I - cum), both exponents <= 0) left of the diagonal and direct
  on the diagonal sub-blocks, at several sub-chunk sizes, with logw at,
  far below and above the clip.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import normal

from repro.kernels import ops as ref_ops

from repro_torch.kernels.ref import (SCAN_TOL, STATE_TOL, rwkv6_scan_ref,
                                     ssd_scan_ref)
from repro_torch.kernels.rwkv6_scan import LOGW_MIN

TOL = dict(rtol=SCAN_TOL["float32"], atol=SCAN_TOL["float32"])
S_TOL = dict(rtol=STATE_TOL, atol=STATE_TOL)


def ssd_slabs(x, dt, A, Bm, Cm, chunk, slab, s0=None):
    """The tiled ssd kernel's decomposition: per (b, chunk) the causal
    C B^T once; per head its decay; per slab of P columns y and the state
    from that shared tile alone."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    y = torch.empty(B, S, H, P)
    st = torch.zeros(B, H, P, N) if s0 is None else s0.clone()
    tri = torch.ones(L, L, dtype=torch.bool).tril()
    for t0 in range(0, S, L):
        sl = slice(t0, t0 + L)
        cb = torch.einsum("bin,bjn->bij", Cm[:, sl], Bm[:, sl])  # shared
        cum = torch.cumsum(dt[:, sl] * A, dim=1)                 # (B, L, H)
        diff = cum[:, :, None] - cum[:, None, :]                 # (B, L, L, H)
        g = torch.where(tri[None, :, :, None], cb[..., None] *
                        torch.exp(torch.where(tri[None, :, :, None], diff,
                                              -torch.inf)), 0.0)
        wdec = torch.exp(cum[:, -1:] - cum)                      # (B, L, H)
        decay = torch.exp(cum[:, -1])                            # (B, H)
        for p0 in range(0, P, slab):
            ps = slice(p0, p0 + slab)
            xd = x[:, sl, :, ps] * dt[:, sl, :, None]            # (B,L,H,ps)
            s_old = st[:, :, ps]                                 # (B,H,ps,N)
            y[:, sl, :, ps] = torch.einsum("bijh,bjhp->bihp", g, xd) + \
                torch.exp(cum)[..., None] * torch.einsum(
                    "bin,bhpn->bihp", Cm[:, sl], s_old)
            st[:, :, ps] = s_old * decay[..., None, None] + torch.einsum(
                "bjhp,bjh,bjn->bhpn", xd, wdec, Bm[:, sl])
    return y, st


def rwkv_slabs(r, k, v, logw, u, chunk, slab, sub, s0=None):
    """The tiled rwkv kernel's decomposition: per chunk the score tile A
    from sub-chunk factors left of the diagonal and direct exponentials on
    the diagonal sub-blocks; per slab of V columns o and the state."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    L = min(chunk, S)
    w = torch.clamp(logw, LOGW_MIN, 0.0)
    o = torch.empty(B, S, H, V)
    st = torch.zeros(B, H, K, V) if s0 is None else s0.clone()
    for t0 in range(0, S, L):
        sl = slice(t0, t0 + L)
        rc, kc, vc = r[:, sl], k[:, sl], v[:, sl]                # (B,L,H,*)
        cum = torch.cumsum(w[:, sl], dim=1)
        cex = cum - w[:, sl]
        a = torch.zeros(B, H, L, L)
        rdec = torch.empty(B, L, H, K)
        for i0 in range(0, L, sub):
            rows = slice(i0, i0 + sub)
            ref = cex[:, i0:i0 + 1]                              # (B,1,H,K)
            rf = rc[:, rows] * torch.exp(cex[:, rows] - ref)     # <= r
            rdec[:, rows] = rc[:, rows] * torch.exp(cex[:, rows])
            if i0:
                kf = kc[:, :i0] * torch.exp(ref - cum[:, :i0])   # <= k
                a[:, :, rows, :i0] = torch.einsum("bihk,bjhk->bhij", rf, kf)
            for i in range(i0 + 1, i0 + sub):                    # diagonal
                for j in range(i0, i):
                    a[:, :, i, j] = torch.einsum(
                        "bhk,bhk->bh", rc[:, i] * kc[:, j],
                        torch.exp(cex[:, i] - cum[:, j]))
        assert bool(torch.isfinite(a).all())
        bonus = torch.einsum("bihk,hk,bihk->bih", rc, u, kc)
        kdec = kc * torch.exp(cum[:, -1:] - cum)
        for v0 in range(0, V, slab):
            vs = slice(v0, v0 + slab)
            s_old = st[..., vs]
            o[:, sl, :, vs] = torch.einsum("bhij,bjhv->bihv", a, vc[..., vs]) \
                + bonus[..., None] * vc[..., vs] + torch.einsum(
                    "bihk,bhkv->bihv", rdec, s_old)
            st[..., vs] = s_old * torch.exp(cum[:, -1])[..., None] + \
                torch.einsum("bjhk,bjhv->bhkv", kdec, vc[..., vs])
    return o, st


def _ssd_inputs(B, S, H, P, N, seed):
    x = normal((B, S, H, P), seed)
    dt = np.log1p(np.exp(normal((B, S, H), seed + 1)))
    A = -np.exp(normal((H,), seed + 2, 0.5))
    return (x, dt, A, normal((B, S, N), seed + 3), normal((B, S, N), seed + 4),
            normal((B, H, P, N), seed + 5, 0.5))


@pytest.mark.parametrize("B,S,H,P,N,chunk,slab", [
    (2, 64, 3, 16, 8, 16, 8), (1, 128, 2, 32, 16, 32, 16),
    (2, 128, 3, 64, 64, 64, 16), (1, 128, 2, 64, 64, 64, 32)])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_p_slabs_with_shared_scores_match_the_scan(B, S, H, P, N, chunk,
                                                      slab, init):
    *args, s0 = _ssd_inputs(B, S, H, P, N, seed=B + S + P)
    t = [torch.as_tensor(a) for a in args]
    ts0 = torch.as_tensor(s0) if init else None
    y, s = ssd_slabs(*t, chunk=chunk, slab=slab, s0=ts0)
    want_y, want_s = ssd_scan_ref(*t, ts0)
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(s, want_s, **S_TOL)
    if not init:   # the TPU kernel starts from a zero state
        pallas = ref_ops.mamba2_ssd(*[jnp.asarray(a) for a in args],
                                    chunk=chunk, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(pallas), **TOL)


def _rwkv_inputs(B, S, H, K, V, logw_case, seed):
    r = normal((B, S, H, K), seed)
    k = normal((B, S, H, K), seed + 1)
    v = normal((B, S, H, V), seed + 2)
    logw = -np.log1p(np.exp(normal((B, S, H, K), seed + 3))) - 0.5
    if logw_case == "at_clip":           # every cum at -6 per step
        logw = np.full_like(logw, LOGW_MIN)
    elif logw_case == "below_clip":      # clipped to -6 everywhere
        logw = np.full_like(logw, -40.0)
    elif logw_case == "mixed":           # random, some rows below the clip
        logw[:, ::5] -= 30.0
        logw[:, 1::7] = 0.5              # above the clip at 0
    u = normal((H, K), seed + 4, 0.1)
    return (r, k, v, logw.astype(np.float32), u,
            normal((B, H, K, V), seed + 5, 0.5))


@pytest.mark.parametrize("logw_case", ["at_clip", "below_clip", "mixed"])
@pytest.mark.parametrize("sub", [4, 8, 16])
def test_rwkv_v_slabs_with_factored_scores_match_the_scan(logw_case, sub):
    *args, _ = _rwkv_inputs(2, 64, 2, 32, 32, logw_case, seed=sub)
    t = [torch.as_tensor(a) for a in args]
    o, s = rwkv_slabs(*t, chunk=32, slab=16, sub=sub)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    want_o, want_s = rwkv6_scan_ref(*t)
    torch.testing.assert_close(o, want_o, **TOL)
    torch.testing.assert_close(s, want_s, **S_TOL)
    pallas = ref_ops.rwkv6_wkv(*[jnp.asarray(a) for a in args], chunk=32,
                               interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("B,S,H,K,V,chunk,slab", [
    (1, 32, 1, 8, 8, 8, 8), (2, 64, 3, 16, 16, 16, 16),
    (1, 96, 2, 32, 16, 32, 16), (2, 64, 2, 64, 64, 32, 32)])
def test_rwkv_v_slabs_carry_an_initial_state(B, S, H, K, V, chunk, slab):
    *args, s0 = _rwkv_inputs(B, S, H, K, V, "mixed", seed=S + K)
    t = [torch.as_tensor(a) for a in args]
    ts0 = torch.as_tensor(s0)
    o, s = rwkv_slabs(*t, chunk=chunk, slab=slab, sub=8, s0=ts0)
    want_o, want_s = rwkv6_scan_ref(*t, ts0)
    torch.testing.assert_close(o, want_o, **TOL)
    torch.testing.assert_close(s, want_s, **S_TOL)


def test_factors_stay_within_their_operands_at_the_deepest_decay():
    # logw at the clip for a whole chunk of 32: cum_ex down to -186, far
    # past float32's exp range, yet every factor is r or k times e^(<= 0)
    *args, _ = _rwkv_inputs(1, 32, 1, 64, 16, "at_clip", seed=3)
    r, k, _, logw, _ = (torch.as_tensor(a) for a in args)
    cum = torch.cumsum(logw, dim=1)
    cex = cum - logw
    assert float(cum.min()) == pytest.approx(32 * LOGW_MIN)
    for i0 in range(8, 32, 8):
        ref = cex[:, i0:i0 + 1]
        rf = r[:, i0:i0 + 8] * torch.exp(cex[:, i0:i0 + 8] - ref)
        kf = k[:, :i0] * torch.exp(ref - cum[:, :i0])
        assert bool((rf.abs() <= r[:, i0:i0 + 8].abs()).all())
        assert bool((kf.abs() <= k[:, :i0].abs()).all())
        assert bool(torch.isfinite(rf).all() and torch.isfinite(kf).all())
