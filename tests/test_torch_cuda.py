"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and `nvcc`; elsewhere they skip.  On a
machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from _torch_inputs import DEEP_BF16, RTOL, TOL, normal, population, queues

from repro_torch.api.session import ExplorationSession
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.configs.paper_workloads import squeezenet
from repro_torch.core.vectorized import BatchedFitness
from repro_torch.hw import catalog
from repro_torch.hw.catalog import mc_hetero, mc_hom_tpu_chip4
from repro_torch.kernels import ref
from repro_torch.kernels import decode_attention as decode_module
from repro_torch.kernels import flash_attention as flash_module
from repro_torch.kernels import moe_gemm as moe_gemm_module
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels import rmsnorm as rmsnorm_module
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.ref import (decode_attention_ref,
                                     flash_attention_ref,
                                     flash_attention_top_left_ref,
                                     moe_gemm_ref, rmsnorm_ref,
                                     rwkv6_scan_ref, serialize_prefix_ref,
                                     ssd_scan_ref)
from repro_torch.kernels.rmsnorm import rmsnorm_fwd
from repro_torch.kernels import rwkv6_scan as rwkv_module
from repro_torch.kernels import ssd_scan as ssd_module
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels import wavefront as wfm
from repro_torch.kernels.wavefront import serialize_prefix, wavefront_scan
from repro_torch.models import encdec, layers, zoo
from repro_torch.models.attention import mla_temperature
from repro_torch.models.module import init_from_specs
from repro_torch.models.transformer import logits_f32

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("rows,w", [(1, 1), (5, 7), (1280, 17), (2048, 28),
                                    (40, 33), (300, 257)])
def test_serialize_kernel_matches_plain(cuda, rows, w):
    args = [torch.as_tensor(a, device=cuda) for a in queues(rows, w, rows)]
    before = serialize_prefix.launches
    fin, free = serialize_prefix(*args)
    assert serialize_prefix.launches == before + 1
    want_fin, want_free = serialize_prefix_ref(*args)
    torch.cuda.synchronize()
    if w <= 32:   # one tile: the same shift-doubling sum order
        assert torch.equal(fin, want_fin) and torch.equal(free, want_free)
    torch.testing.assert_close(fin, want_fin, rtol=RTOL, atol=0.0)
    torch.testing.assert_close(free, want_free, rtol=RTOL, atol=0.0)


def test_serialize_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    free0, release, dur = (torch.as_tensor(a, device=cuda)
                           for a in queues(8, 5, 0))
    with pytest.raises(TypeError):
        serialize_prefix(free0.double(), release.double(), dur.double())
    with pytest.raises(ValueError):
        serialize_prefix(free0, release.t().contiguous().t(), dur)
    with pytest.raises(ValueError):
        serialize_prefix(free0.cpu(), release, dur)


@pytest.mark.parametrize("arch", [mc_hetero, mc_hom_tpu_chip4])
def test_fitness_kernel_path_matches_plain_and_cpu(cuda, arch):
    acc = arch()
    w = squeezenet()
    engine = ExplorationSession(device=cuda).engine(w, acc, ("tile", 8, 1))
    pop = population(w, acc, 16, seed=1)
    kern = BatchedFitness(engine, device=cuda)
    assert kern.contention == "serialize" and kern.route == "fused"
    before = (wavefront_scan.launches, serialize_prefix.launches)
    s_k = kern.scores(pop)
    # the fused route: one scan launch for the one chunk, no queue launch
    assert (wavefront_scan.launches - before[0],
            serialize_prefix.launches - before[1]) == (1, 0)
    s_p = BatchedFitness(engine, device=cuda, use_kernel=False).scores(pop)
    s_c = BatchedFitness(engine, device="cpu",
                         contention="serialize").scores(pop)
    np.testing.assert_allclose(s_k, s_p, rtol=RTOL)
    np.testing.assert_allclose(s_k, s_c, rtol=RTOL)


FITNESS_ARCHS = ["mc_hetero", "mc_hom_tpu_chip4", "diana", "aimc_4x4",
                 "depfin"]


def _fitness(cuda, arch, tile, **kw):
    acc = getattr(catalog, arch)()
    w = squeezenet()
    engine = ExplorationSession(device=cuda).engine(w, acc, ("tile", tile, 1))
    return engine, population(w, acc, 24, seed=2, spread=True), kw


@pytest.mark.parametrize("tile", [8, 32])
@pytest.mark.parametrize("arch", FITNESS_ARCHS)
def test_fused_scan_matches_plain_and_cpu(cuda, arch, tile):
    """The fused route against the plain loop on the card (bit for bit: each
    operation rounds as the plain loop does at W <= 32) and against the CPU
    within RTOL, with the spill model on and off."""
    for spills in (True, False):
        engine, pop, kw = _fitness(cuda, arch, tile, model_spills=spills)
        fused = BatchedFitness(engine, device=cuda, **kw)
        assert fused.route == "fused"
        s_f = fused.scores(pop)
        s_p = BatchedFitness(engine, device=cuda, use_kernel=False,
                             **kw).scores(pop)
        s_c = BatchedFitness(engine, device="cpu", contention="serialize",
                             **kw).scores(pop)
        worst = float(np.max(np.abs(s_f - s_c) / np.abs(s_c)))
        print(f"{arch} tile {tile} spills {spills}: fused vs plain "
              f"{float(np.max(np.abs(s_f - s_p) / np.abs(s_p)))}, "
              f"vs CPU {worst}")
        assert np.array_equal(s_f, s_p)
        np.testing.assert_allclose(s_f, s_c, rtol=RTOL)


def test_fused_route_launches_once_a_chunk(cuda):
    engine, _, _ = _fitness(cuda, "mc_hetero", 8)
    w, acc = engine.cost_model.workload, engine.accelerator
    pop = population(w, acc, 300, seed=3)
    fused = BatchedFitness(engine, device=cuda)
    chunks = -(-len(pop) // fused.chunk_size(len(pop)))
    assert chunks == 2
    before = (wavefront_scan.launches, serialize_prefix.launches)
    fused.scores(pop)
    assert (wavefront_scan.launches - before[0],
            serialize_prefix.launches - before[1]) == (chunks, 0)


@pytest.mark.parametrize("arch", ["mc_hetero", "mc_hom_tpu_chip4", "diana"])
def test_step_route_launches_a_queue_kernel_a_wavefront(cuda, arch):
    engine, pop, _ = _fitness(cuda, arch, 8)
    step = BatchedFitness(engine, device=cuda, kernel="step")
    before = (wavefront_scan.launches, serialize_prefix.launches)
    s_s = step.scores(pop)
    assert (wavefront_scan.launches - before[0],
            serialize_prefix.launches - before[1]) == (
                0, step.n_wavefronts * (2 if step.comm else 1))
    s_f = BatchedFitness(engine, device=cuda).scores(pop)
    assert np.array_equal(s_s, s_f)


def test_scan_layout_mirrors_the_source(cuda):
    from repro_torch.kernels import build
    lib = build.load_library("wavefront")
    for args in [(601, 17, 5, 1, 31, 7), (986, 28, 5, 8, 38, 13),
                 (227, 7, 17, 0, 31, 7), (5000, 32, 16, 8, 60, 32)]:
        n, W, C, H, G, D = args
        for flags in range(4):
            comm, spills = bool(flags & 1), bool(flags & 2)
            assert lib.scan_smem_bytes(*args, flags) == wfm.smem_bytes(
                *args, comm=comm, spills=spills)
            r = wfm.record_layout(W, C, H, D, comm, spills)
            assert lib.scan_record_words(W, C, H, D, flags, 0) == r["words"]
            assert lib.scan_record_words(W, C, H, D, flags, 1) == \
                r["static_words"]


def test_wavefront_scan_refuses_what_the_kernel_does_not_take(cuda):
    engine, pop, _ = _fitness(cuda, "mc_hetero", 8)
    bf = BatchedFitness(engine, device=cuda)
    g = torch.as_tensor(pop, device=cuda)
    xs, st, kw = bf.scan_args(g)
    with pytest.raises(TypeError):
        wavefront_scan(g, {**xs, "cyc": xs["cyc"].double()}, st, **kw)
    with pytest.raises(ValueError):
        wavefront_scan(g, {**xs, "cyc": xs["cyc"].cpu()}, st, **kw)
    with pytest.raises(ValueError):
        wavefront_scan(g, {**xs, "occ": xs["occ"][:, :, :-1]}, st, **kw)
    with pytest.raises(ValueError):
        wavefront_scan(g[:-1], xs, st, **kw)
    backlog = {k: v for k, v in xs.items() if k != "on"}
    with pytest.raises(ValueError):
        wavefront_scan(g, backlog, st, **kw)


# ---- the serving kernels: rmsnorm, decode attention, flash attention -------

def _on(cuda, a, dtype):
    return torch.as_tensor(a, device=cuda).to(getattr(torch, dtype))


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _at_offset(t, offset):
    """`t`'s values in a contiguous tensor that starts `offset` elements
    into its storage: off the 16-byte grid for an offset of 1."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("shape", [(4, 37, 96), (2, 8, 128), (1, 300, 64),
                                   (4, 1, 3072), (4, 128, 3072), (4, 2048),
                                   (4, 2560), (2, 3, 5120), (3, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype, scale_dtype,
                                      offset):
    x = _at_offset(_on(cuda, normal(shape, 0), dtype), offset)
    s = _on(cuda, normal(shape[-1:], 1), scale_dtype)
    per_vector = 16 // x.element_size()
    assert rmsnorm_module.variant(x, s) == (
        "scalar" if offset or shape[-1] % per_vector else "vector")
    before = rmsnorm_fwd.launches
    got = rmsnorm_fwd(x, s)
    assert rmsnorm_fwd.launches == before + 1 and got.dtype == x.dtype
    _close(got, rmsnorm_ref(x, s), dtype)


def _heads(cuda, layout, B, H, T, D, dtype, seed, offset=0):
    """A (B, H, T, D) operand: contiguous in the TPU kernel's layout, or a
    transposed view of the model's (B, T, H, D) activations or cache;
    `offset` elements into its storage (off the 16-byte grid for 1)."""
    shape = (B, T, H, D) if layout == "model" else (B, H, T, D)
    t = _at_offset(_on(cuda, normal(shape, seed), dtype), offset)
    return t.transpose(1, 2) if layout == "model" else t


def _kv(cuda, layout, B, Hkv, T, D, dtype, seed, offset=0):
    """k and v as (B, Hkv, T, D) tensors (see `_heads`)."""
    return [_heads(cuda, layout, B, Hkv, T, D, dtype, seed + i, offset)
            for i in range(2)]


def _bf16_ulps(got, want):
    """The largest |got - want| in bf16 spacings at `want` (float32). The
    spacing is taken at |want| >= 2**-8: below that the float32 sums' own
    error, about 1e-6 from terms near 1, is no longer small against it."""
    want = want.float()
    mag = want.abs().clamp_min(2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got.float() - want).abs() / ulp).max())


@pytest.mark.parametrize("layout,Hq,Hkv", [("tpu", 4, 4), ("model", 24, 8)])
@pytest.mark.parametrize("B,T,D", [(4, 168, 128), (2, 200, 64),
                                   (3, 64, 32), (4, 168, 80)])
@pytest.mark.parametrize("cur", ["zero", "one", "mid", "full", "past"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1])
def test_decode_attention_kernel_matches_plain(cuda, layout, Hq, Hkv, B, T,
                                               D, cur, dtype, offset):
    cur_len = {"zero": 0, "one": 1, "mid": 100 if T > 100 else T // 2,
               "full": T, "past": T + 5}[cur]
    q = _on(cuda, normal((B, Hq, D), 7), dtype)
    k, v = _kv(cuda, layout, B, Hkv, T, D, dtype, 8, offset)
    assert decode_module.variant(q, k, v) == ("head" if offset else "split")
    before = decode_attention_fwd.launches
    got = decode_attention_fwd(q, k, v, cur_len)
    assert decode_attention_fwd.launches == before + 1
    _close(got, decode_attention_ref(q, k, v, cur_len), dtype)


@pytest.mark.parametrize("layout,Hq,Hkv", [("tpu", 3, 3), ("model", 24, 8),
                                           ("model", 16, 2)])
@pytest.mark.parametrize("B,S,D", [(4, 128, 128), (1, 40, 16), (2, 96, 64),
                                   (1, 200, 32), (4, 128, 80), (1, 1, 64),
                                   (2, 65, 80), (1, 200, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1])
def test_flash_attention_kernel_matches_plain(cuda, layout, Hq, Hkv, B, S, D,
                                              causal, dtype, offset):
    q = _heads(cuda, layout, B, Hq, S, D, dtype, 3, offset)
    k, v = _kv(cuda, layout, B, Hkv, S, D, dtype, 4)
    mma = dtype == "bfloat16" and not offset and D % 16 == 0 and D <= 128
    assert flash_module.variant(q, k, v) == ("mma" if mma else "fma")
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=causal)
    assert flash_attention_fwd.launches == before + 1
    assert got.stride() == q.stride()
    _close(got, flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("S,T", [(32, 64), (64, 32), (128, 200), (200, 128),
                                 (1, 65), (65, 1)])
@pytest.mark.parametrize("D", [128, 80, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_flash_attention_with_s_not_t_aligns_top_left(cuda, S, T, D,
                                                            dtype):
    # query i sees keys j <= i, as the TPU kernel does; rows i >= T every key
    q = _heads(cuda, "model", 2, 6, S, D, dtype, 40)
    k, v = _kv(cuda, "model", 2, 2, T, D, dtype, 41)
    mma = dtype == "bfloat16" and D % 16 == 0
    assert flash_module.variant(q, k, v) == ("mma" if mma else "fma")
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=True)
    assert flash_attention_fwd.launches == before + 1
    _close(got, flash_attention_top_left_ref(q, k, v), dtype)


@pytest.mark.parametrize("kernel,D,G", [
    ("flash", 128, 3), ("flash", 128, 1), ("flash", 80, 1), ("flash", 64, 8),
    ("decode", 128, 3), ("decode", 128, 1), ("decode", 80, 1),
    ("decode", 64, 8)])
def test_attention_kernels_in_bf16_keep_p_at_float32_precision(cuda, kernel,
                                                               D, G):
    # the plain version on the same bf16 inputs, in float32 and unrounded:
    # the new kernels round only their output, so they are within 2 bf16
    # spacings of it; p rounded to bf16 before the PV sum would not be
    B, Hkv, S = 4, 8 // min(G, 8), 128
    q = _heads(cuda, "model", B, G * Hkv, S, D, "bfloat16", 30)
    k, v = _kv(cuda, "model", B, Hkv, S, D, "bfloat16", 31)
    if kernel == "flash":
        assert flash_module.variant(q, k, v) == "mma"
        got = flash_attention_fwd(q, k, v, causal=True)
        want = flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=True)
    else:
        q = q[:, :, 0]
        assert decode_module.variant(q, k, v) == "split"
        got = decode_attention_fwd(q, k, v, 100)
        want = decode_attention_ref(q.float(), k.float(), v.float(), 100)
    assert _bf16_ulps(got, want) <= 2.0


def test_serving_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.ones(4, 8, device=cuda)
    with pytest.raises(TypeError):
        rmsnorm_fwd(x.double(), torch.ones(8, device=cuda))
    with pytest.raises(ValueError):
        rmsnorm_fwd(x.t(), torch.ones(4, device=cuda))
    q = torch.ones(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError):          # D must be contiguous
        flash_attention_fwd(q.transpose(2, 3), q.transpose(2, 3),
                            q.transpose(2, 3), causal=False)
    with pytest.raises(TypeError):
        decode_attention_fwd(q[:, :, 0].half(), q, q, 3)


# ---- the serving path on the card ------------------------------------------

def test_logits_f32_on_the_card_equal_float32_operands(cuda):
    x = _on(cuda, normal((4, 256), 11), "bfloat16")
    head = _on(cuda, normal((1000, 256), 12, 0.02), "bfloat16")
    got = logits_f32(x, head)
    assert got.dtype == torch.float32
    # bf16 products are exact in float32; only the order of sums differs
    torch.testing.assert_close(got, x.float() @ head.float().t(),
                               rtol=1e-5, atol=1e-5)


# ---- the scans and the expert GEMM ----------------------------------------

# the tolerances of repro_torch.kernels.ref, which chip_smoke.py holds too
SCAN_TOL = {k: dict(rtol=t, atol=t) for k, t in ref.SCAN_TOL.items()}
STATE_TOL = dict(rtol=ref.STATE_TOL, atol=ref.STATE_TOL)


# (B, S, H, P, N, chunk): every shape takes the tiled kernel but N = 4 in
# bf16 (8 bytes a row), which takes the old one; L, P and N off the tensor
# cores' 16 and P off the slab of 32 (zero-padded tiles) included
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 32, 1, 8, 4, 8), (2, 64, 3, 16, 8, 16), (1, 128, 2, 32, 16, 32),
    (4, 128, 80, 64, 64, 64), (2, 64, 5, 64, 64, 64), (1, 48, 2, 8, 8, 8),
    (2, 72, 3, 48, 24, 24), (1, 80, 2, 80, 40, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("kernel", [None, "old"])
def test_ssd_scan_kernel_matches_plain(cuda, B, S, H, P, N, chunk, dtype,
                                       init, kernel):
    x = _on(cuda, normal((B, S, H, P), 0), dtype)
    dt = torch.nn.functional.softplus(_on(cuda, normal((B, S, H), 1),
                                          "float32"))
    A = -torch.exp(_on(cuda, normal((H,), 2, 0.5), "float32"))
    Bm = _on(cuda, normal((B, S, N), 3), dtype)
    Cm = _on(cuda, normal((B, S, N), 4), dtype)
    s0 = _on(cuda, normal((B, H, P, N), 5), "float32") if init else None
    route = ssd_module.variant(x, Bm, Cm, chunk)
    assert route == ("old" if N == 4 and dtype == "bfloat16" else "tiled")
    if route == "old":
        with pytest.raises(ValueError):      # not the tiled kernel's call
            ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, kernel="tiled")
    before = ssd_scan.launches
    y, s = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=s0,
                    kernel=kernel)
    assert ssd_scan.launches == before + 1 and y.dtype == x.dtype
    want_y, want_s = ssd_scan_ref(x, dt, A, Bm, Cm, s0)
    torch.testing.assert_close(y.float(), want_y.float(), **SCAN_TOL[dtype])
    torch.testing.assert_close(s, want_s, **STATE_TOL)


def test_ssd_scan_kernel_takes_the_models_strided_slices(cuda):
    # x, B and C as slices of one (B, S, d_inner + 2N) conv output
    conv = _on(cuda, normal((2, 64, 4 * 16 + 2 * 8), 6), "bfloat16")
    x = conv[..., :64].reshape(2, 64, 4, 16)
    Bm, Cm = conv[..., 64:72], conv[..., 72:]
    dt = torch.nn.functional.softplus(_on(cuda, normal((2, 64, 4), 7),
                                          "float32"))
    A = -torch.exp(_on(cuda, normal((4,), 8, 0.5), "float32"))
    assert ssd_module.variant(x, Bm, Cm, 32) == "tiled"
    y, s = ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    want_y, want_s = ssd_scan_ref(x.contiguous(), dt, A, Bm.contiguous(),
                                  Cm.contiguous())
    torch.testing.assert_close(y.float(), want_y.float(),
                               **SCAN_TOL["bfloat16"])
    torch.testing.assert_close(s, want_s, **STATE_TOL)


# (B, S, H, K, V, chunk): L off the tensor cores' 16, K off 16 and V off the
# slab of 32 (zero-padded tiles) included
@pytest.mark.parametrize("B,S,H,K,V,chunk", [
    (1, 32, 1, 8, 8, 8), (2, 64, 3, 16, 16, 16), (1, 96, 2, 32, 16, 32),
    (4, 128, 40, 64, 64, 32), (2, 64, 3, 64, 32, 32), (2, 72, 3, 64, 48, 24),
    (1, 64, 2, 40, 80, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("logw_case", ["some_below", "at_clip",
                                       "all_below"])
@pytest.mark.parametrize("kernel", [None, "old"])
def test_rwkv6_scan_kernel_matches_plain(cuda, B, S, H, K, V, chunk, dtype,
                                         init, logw_case, kernel):
    r = _on(cuda, normal((B, S, H, K), 0), dtype)
    k = _on(cuda, normal((B, S, H, K), 1), dtype)
    v = _on(cuda, normal((B, S, H, V), 2), dtype)
    logw = -torch.nn.functional.softplus(
        _on(cuda, normal((B, S, H, K), 3), "float32")) - 0.5
    if logw_case == "some_below":
        logw[:, ::7] = -20.0                 # below the clip at -6
    else:                                    # every cum at -6 L
        logw.fill_(-6.0 if logw_case == "at_clip" else -40.0)
    u = _on(cuda, normal((H, K), 4, 0.1), "float32")
    s0 = _on(cuda, normal((B, H, K, V), 5), "float32") if init else None
    assert rwkv_module.variant(r, k, v, logw, chunk) == "tiled"
    before = rwkv6_scan.launches
    o, s = rwkv6_scan(r, k, v, logw, u, chunk=chunk, initial_state=s0,
                      kernel=kernel)
    assert rwkv6_scan.launches == before + 1 and o.dtype == r.dtype
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    want_o, want_s = rwkv6_scan_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(o.float(), want_o.float(), **SCAN_TOL[dtype])
    torch.testing.assert_close(s, want_s, **STATE_TOL)


@pytest.mark.parametrize("kernel", ["ssd_scan", "rwkv6_scan"])
def test_scans_off_the_tiled_grid_take_the_old_kernel(cuda, kernel):
    # views off the 16-byte grid: the old kernel, held alike
    if kernel == "ssd_scan":
        x = _at_offset(_on(cuda, normal((2, 64, 3, 16), 0), "bfloat16"), 1)
        dt = torch.nn.functional.softplus(_on(cuda, normal((2, 64, 3), 1),
                                              "float32"))
        A = -torch.exp(_on(cuda, normal((3,), 2, 0.5), "float32"))
        Bm, Cm = (_on(cuda, normal((2, 64, 8), i), "bfloat16")
                  for i in (3, 4))
        assert ssd_module.variant(x, Bm, Cm, 16) == "old"
        got = ssd_scan(x, dt, A, Bm, Cm, chunk=16)
        want = ssd_scan_ref(x, dt, A, Bm, Cm)
    else:
        r = _at_offset(_on(cuda, normal((2, 64, 3, 16), 0), "bfloat16"), 1)
        k, v = (_on(cuda, normal((2, 64, 3, 16), i), "bfloat16")
                for i in (1, 2))
        logw = -torch.nn.functional.softplus(
            _on(cuda, normal((2, 64, 3, 16), 3), "float32")) - 0.5
        u = _on(cuda, normal((3, 16), 4, 0.1), "float32")
        assert rwkv_module.variant(r, k, v, logw, 16) == "old"
        got = rwkv6_scan(r, k, v, logw, u, chunk=16)
        want = rwkv6_scan_ref(r, k, v, logw, u)
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               **SCAN_TOL["bfloat16"])
    torch.testing.assert_close(got[1], want[1], **STATE_TOL)


# ---- the shapes of whisper, qwen2-vl and deepseek-v2 ----------------------

@pytest.mark.parametrize("S", [1, 128, 1500])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_whisper_shapes(cuda, S, dtype):
    """whisper-large-v3: 20 heads of D 64, non-causal against the 1500
    encoder frames; S 1500 is the encoder, S 128 a prefill's cross
    attention, S 1 a decode step's, all in the model's transposed views."""
    q = _heads(cuda, "model", 2, 20, S, 64, dtype, 21)
    k, v = _kv(cuda, "model", 2, 20, 1500, 64, dtype, 22)
    assert flash_module.variant(q, k, v) == (
        "mma" if dtype == "bfloat16" else "fma")
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=False)
    assert flash_attention_fwd.launches == before + 1
    _close(got, flash_attention_ref(q, k, v, causal=False), dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_whisper_self_attention(cuda, causal, dtype):
    """whisper-large-v3's decoder self attention at prefill: S = T = 128,
    20 query heads over 20 KV heads (G 1), D 64, in the model's views; in
    bf16 the tensor-core kernel, within 2 bf16 spacings of the float32
    plain version."""
    q = _heads(cuda, "model", 4, 20, 128, 64, dtype, 27)
    k, v = _kv(cuda, "model", 4, 20, 128, 64, dtype, 28)
    assert flash_module.variant(q, k, v) == (
        "mma" if dtype == "bfloat16" else "fma")
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=causal)
    assert flash_attention_fwd.launches == before + 1
    _close(got, flash_attention_ref(q, k, v, causal=causal), dtype)
    if dtype == "bfloat16":
        assert _bf16_ulps(got, flash_attention_ref(
            q.float(), k.float(), v.float(), causal=causal)) <= 2.0


@pytest.mark.parametrize("cur_len", [0, 1, 129, 143, 168])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_at_whisper_self_attention(cuda, cur_len, dtype):
    """whisper-large-v3's decoder self attention at a decode step: 20 query
    heads over 20 KV heads (G 1), D 64, the model's (B, T, H, D) cache of
    168 positions as a transposed view."""
    q = _on(cuda, normal((4, 20, 64), 29), dtype)
    k, v = _kv(cuda, "model", 4, 20, 168, 64, dtype, 30)
    assert decode_module.variant(q, k, v) == "split"
    before = decode_attention_fwd.launches
    got = decode_attention_fwd(q, k, v, cur_len)
    assert decode_attention_fwd.launches == before + 1
    _close(got, decode_attention_ref(q, k, v, cur_len), dtype)
    if dtype == "bfloat16":
        assert _bf16_ulps(got, decode_attention_ref(
            q.float(), k.float(), v.float(), cur_len)) <= 2.0


@pytest.mark.parametrize("cur_len", [1, 129, 150, 168])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_at_g8(cuda, cur_len, dtype):
    """qwen2-vl-72b: 64 query heads over 8 KV heads (G 8), D 128, the
    model's (B, T, Hkv, D) cache as a transposed view."""
    q = _on(cuda, normal((4, 64, 128), 23), dtype)
    k, v = _kv(cuda, "model", 4, 8, 168, 128, dtype, 24)
    assert decode_module.variant(q, k, v) == "split"
    before = decode_attention_fwd.launches
    got = decode_attention_fwd(q, k, v, cur_len)
    assert decode_attention_fwd.launches == before + 1
    _close(got, decode_attention_ref(q, k, v, cur_len), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_of_mla_latent_from_its_contiguous_copy(cuda, dtype):
    """deepseek-v2's kv_norm: the first 512 of each 576-wide row of
    `x @ wkv_a`.  The kernel takes the contiguous copy (the vector path)
    and refuses the strided view, which the model never passes."""
    kv = _on(cuda, normal((4, 128, 576), 25), dtype)
    s = _on(cuda, 1 + normal((512,), 26, 0.3), dtype)
    latent = kv[..., :512]
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_fwd(latent, s)
    x = latent.contiguous()
    assert rmsnorm_module.variant(x, s) == "vector"
    before = rmsnorm_fwd.launches
    got = rmsnorm_fwd(x, s)
    assert rmsnorm_fwd.launches == before + 1
    _close(got, rmsnorm_ref(x, s), dtype)


@pytest.mark.parametrize("C", [8, 24])
@pytest.mark.parametrize("K,N", [(5120, 1536), (1536, 5120)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gemm_at_deepseek_v2_shapes(cuda, C, K, N, dtype):
    """160 routed experts, d_model 5120, d_ff_expert 1536: C 8 at a decode
    step of 4 slots and C 24 at a prefill of 4 x 128 tokens (top 6).  The
    1.26 G weights are drawn on the card from a seeded generator."""
    gen = torch.Generator(device=cuda).manual_seed(28)
    x = _on(cuda, normal((160, C, K), 27, 1.0), dtype)
    w = (0.02 * torch.randn((160, K, N), generator=gen, device=cuda)).to(
        getattr(torch, dtype))
    assert moe_gemm_module.variant(x, w) == (
        "mma" if dtype == "bfloat16" else "fma")
    before = moe_gemm.launches
    got = moe_gemm(x, w)
    assert moe_gemm.launches == before + 1
    tol = ref.MOE_TOL[dtype]
    torch.testing.assert_close(got.float(), moe_gemm_ref(x, w).float(),
                               rtol=tol, atol=tol)


# the serving shapes, and every C tile edge of the tensor-core kernel with
# K and N multiples of 8 (its route) and not (the CUDA-core route)
@pytest.mark.parametrize("E,C,K,N", [
    (2, 32, 64, 48), (4, 64, 96, 80), (1, 128, 128, 128),
    (64, 8, 2048, 1408), (64, 60, 1408, 2048), (3, 17, 33, 65)] + [
    (2, C, K, N) for C in (1, 8, 9, 16, 17, 60, 64, 65)
    for K, N in ((64, 48), (33, 65))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1])
def test_moe_gemm_kernel_matches_plain(cuda, E, C, K, N, dtype, offset):
    x = _at_offset(_on(cuda, normal((E, C, K), 0, 0.3), dtype), offset)
    w = _on(cuda, normal((E, K, N), 1, 0.3), dtype)
    tensor_cores = dtype == "bfloat16" and K % 8 == 0 and N % 8 == 0 and \
        not offset
    assert moe_gemm_module.variant(x, w) == ("mma" if tensor_cores
                                             else "fma")
    before = moe_gemm.launches
    got = moe_gemm(x, w)
    assert moe_gemm.launches == before + 1 and got.dtype == x.dtype
    tol = ref.MOE_TOL[dtype]
    torch.testing.assert_close(got.float(), moe_gemm_ref(x, w).float(),
                               rtol=tol, atol=tol)


def test_scan_and_gemm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.ones(1, 16, 2, 8, device=cuda)
    dt = torch.ones(1, 16, 2, device=cuda)
    A = -torch.ones(2, device=cuda)
    Bm = torch.ones(1, 16, 4, device=cuda)
    with pytest.raises(TypeError):
        ssd_scan(x, dt.double(), A, Bm, Bm)
    with pytest.raises(TypeError):
        ssd_scan(x.bfloat16(), dt, A, Bm, Bm)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm.cpu(), Bm)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm, Bm, initial_state=torch.ones(
            1, 2, 8, 4, device=cuda).transpose(2, 3).contiguous().transpose(
                2, 3))
    r = torch.ones(1, 16, 2, 8, device=cuda)
    u = torch.ones(2, 8, device=cuda)
    with pytest.raises(TypeError):
        rwkv6_scan(r, r, r.bfloat16(), r, u)
    with pytest.raises(ValueError):
        rwkv6_scan(r.transpose(1, 2).contiguous().transpose(1, 2), r, r, r,
                   u)
    with pytest.raises(TypeError):           # logw is read as float32
        rwkv6_scan(r, r, r, r.bfloat16(), u)
    with pytest.raises(TypeError):
        moe_gemm(torch.ones(2, 4, 8, device=cuda),
                 torch.ones(2, 8, 4, device=cuda).bfloat16())
    with pytest.raises(ValueError):
        moe_gemm(torch.ones(2, 8, 4, device=cuda).transpose(1, 2),
                 torch.ones(2, 8, 4, device=cuda))


@pytest.mark.parametrize("kernel", ["rmsnorm", "moe_gemm", "flash_attention",
                                    "decode_attention", "ssd_scan",
                                    "rwkv6_scan"])
def test_kernel_captured_in_a_cuda_graph_replays_as_the_eager_call(cuda,
                                                                   kernel):
    if kernel == "rmsnorm":
        x = _on(cuda, normal((4, 3072), 20), "bfloat16")
        y = _on(cuda, normal((3072,), 21), "bfloat16")
        fn, launches = (lambda: rmsnorm_fwd(x, y)), rmsnorm_fwd
    elif kernel == "moe_gemm":
        x = _on(cuda, normal((8, 8, 256), 20, 0.3), "bfloat16")
        y = _on(cuda, normal((8, 256, 128), 21, 0.3), "bfloat16")
        fn, launches = (lambda: moe_gemm(x, y)), moe_gemm
        assert moe_gemm_module.variant(x, y) == "mma"
    elif kernel == "flash_attention":
        x = _on(cuda, normal((4, 24, 128, 128), 20), "bfloat16")
        y, z = _kv(cuda, "tpu", 4, 8, 128, 128, "bfloat16", 21)
        fn, launches = (lambda: flash_attention_fwd(x, y, z)), \
            flash_attention_fwd
        assert flash_module.variant(x, y, z) == "mma"
    elif kernel == "decode_attention":   # a cluster launch
        x = _on(cuda, normal((4, 24, 128), 20), "bfloat16")
        y, z = _kv(cuda, "model", 4, 8, 168, 128, "bfloat16", 21)
        fn, launches = (lambda: decode_attention_fwd(x, y, z, 144)), \
            decode_attention_fwd
        assert decode_module.variant(x, y, z) == "split"
    elif kernel == "ssd_scan":        # zamba2's prefill, state in and out
        x = _on(cuda, normal((4, 128, 80, 64), 20), "bfloat16")
        y, z = (_on(cuda, normal((4, 128, 64), i), "bfloat16")
                for i in (21, 23))
        dt = torch.nn.functional.softplus(_on(cuda, normal((4, 128, 80), 24),
                                              "float32"))
        A = -torch.exp(_on(cuda, normal((80,), 25, 0.5), "float32"))
        s0 = _on(cuda, normal((4, 80, 64, 64), 26), "float32")
        fn, launches = (lambda: ssd_scan(x, dt, A, y, z, initial_state=s0)), \
            ssd_scan
        assert ssd_module.variant(x, y, z) == "tiled"
    else:                             # rwkv6's prefill, state in and out
        x = _on(cuda, normal((4, 128, 40, 64), 20), "bfloat16")
        y, z = (_on(cuda, normal((4, 128, 40, 64), i), "bfloat16")
                for i in (21, 23))
        logw = -torch.nn.functional.softplus(
            _on(cuda, normal((4, 128, 40, 64), 24), "float32")) - 0.5
        u = _on(cuda, normal((40, 64), 25, 0.1), "float32")
        s0 = _on(cuda, normal((4, 40, 64, 64), 26), "float32")
        fn, launches = (lambda: rwkv6_scan(x, y, z, logw, u,
                                           initial_state=s0)), rwkv6_scan
        assert rwkv_module.variant(x, y, z, logw) == "tiled"
    side = torch.cuda.Stream()       # warm up off the capture, as
    side.wait_stream(torch.cuda.current_stream())   # torch.cuda.graphs asks
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    before = launches.launches
    # new values in the captured input: the replay must read them
    x.copy_(_on(cuda, normal(tuple(x.shape), 22), "bfloat16"))
    want = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert launches.launches == before + 1    # the eager call, not replays
    if isinstance(got, tuple):                # the scans' output and state
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert torch.equal(got, want)


_KERNELS = {"rmsnorm": rmsnorm_fwd, "flash_attention": flash_attention_fwd,
            "decode_attention": decode_attention_fwd, "ssd_scan": ssd_scan,
            "rwkv6_scan": rwkv6_scan, "moe_gemm": moe_gemm}


def _kernel_and_plain_logits(cfg, params, toks, device):
    """Prefill and one decode step on the kernel path and on the plain path,
    with each kernel's launches checked: {path: (prefill, decode) logits}.
    Whisper gets seeded frame embeddings, and its decode step the encoder
    output of the same path."""
    pre_n, step_n = zoo.kernel_launches(cfg)
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["enc_embeds"] = _on(device, normal(
            (2, cfg.enc["enc_len"], cfg.d_model), 14), "float32").to(
                cfg.dtype)
    out = {}
    for name, kernels in (("kernels", None), ("plain", False)):
        caches = init_from_specs(zoo.build_cache_specs(cfg, 2, 40), 0,
                                 device=device)
        before = {k: fn.launches for k, fn in _KERNELS.items()}
        pre, caches = zoo.prefill(cfg, params, batch, caches,
                                  kernels=kernels)
        enc = None
        if cfg.family == "encdec":
            enc = encdec.encode(cfg, params, batch["enc_embeds"],
                                kernels=False)
        dec, _ = zoo.decode_step(cfg, params, pre.argmax(-1)[:, None],
                                 caches, 32, enc_out=enc, kernels=kernels)
        used = {k: fn.launches - before[k] for k, fn in _KERNELS.items()}
        want = {k: pre_n.get(k, 0) + step_n.get(k, 0) for k in _KERNELS}
        assert used == (want if kernels is None else dict.fromkeys(used, 0))
        out[name] = (pre, dec)
    return out


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-34b", "zamba2-2.7b",
                                  "rwkv6-3b", "deepseek-moe-16b",
                                  "whisper-large-v3", "qwen2-vl-72b",
                                  "deepseek-v2-236b"])
def test_reduced_decoder_kernel_path_matches_plain_path(cuda, arch):
    cfg = reduce_config(ARCHS[arch])
    params = init_from_specs(zoo.build_param_specs(cfg), 0, device=cuda)
    toks = torch.as_tensor(normal((2, 32), 13) > 0, device=cuda).long() + 5
    out = _kernel_and_plain_logits(cfg, params, toks, cuda)
    # the kernels round in other places than the plain layers; through the
    # recurrent and MoE stacks that compounds as it does across packages
    tol = TOL["bfloat16"] if cfg.mixer == "gqa" and cfg.ffn != "moe" \
        else DEEP_BF16["logits"]
    for got, want in zip(out["kernels"], out["plain"]):
        torch.testing.assert_close(got.float(), want.float(), **tol)
    # in float32 no bf16 rounding feeds that divergence: the two paths
    # differ only in the order of float32 sums, so they are held closely
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = init_from_specs(zoo.build_param_specs(cfg), 0, device=cuda)
    out = _kernel_and_plain_logits(cfg, params, toks, cuda)
    for got, want in zip(out["kernels"], out["plain"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training on the card: the plain layers, no kernel, the CPU's numbers
# ---------------------------------------------------------------------------

def _rel(got, want) -> float:
    """Largest difference relative to the largest magnitude of `want`."""
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _train_once(cfg, params, batch, step_cfg):
    from repro_torch.models.module import tree_map
    from repro_torch.train.train_step import init_train_state, make_train_step
    params = tree_map(torch.clone, params)
    state = init_train_state(cfg, params, step_cfg)
    return make_train_step(cfg, None, step_cfg)(params, state, batch)


def _held(a, b, rtol, b1=0.9, eps=1e-8):
    """Two first-step (params, state, metrics) results: loss, grad norm,
    lr, m and v within `rtol` of each tensor's largest magnitude. A first
    AdamW step moves a parameter by lr (u + wd p) with u = h / (|h| + eps),
    h = m / (1 - b1): a near-zero h can turn u over (float32 sums in
    another order), so the parameters are held to lr |u_a - u_b| from the
    held m, plus `rtol` of their largest magnitude."""
    from repro_torch.models.module import tree_leaves
    pa, sa, ma = a
    pb, sb, mb = b
    for k in ("loss", "grad_norm", "lr"):
        assert _rel(ma[k], mb[k]) <= rtol, (k, _rel(ma[k], mb[k]))
    for k in ("m", "v"):
        for x, y in zip(tree_leaves(sa[k]), tree_leaves(sb[k])):
            assert _rel(x, y) <= rtol, (k, _rel(x, y))
    lr = float(mb["lr"])
    for x, y, m_a, m_b in zip(tree_leaves(pa), tree_leaves(pb),
                              tree_leaves(sa["m"]), tree_leaves(sb["m"])):
        h_a, h_b = m_a.cpu() / (1 - b1), m_b.cpu() / (1 - b1)
        turn = (h_a / (h_a.abs() + eps) - h_b / (h_b.abs() + eps)).abs()
        diff = (x.float().cpu() - y.float().cpu()).abs()
        assert float((diff - lr * turn).max()) <= \
            rtol * float(y.abs().max())


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One float32 step of a reduced llama on the card against the same
    port code on the CPU (which the CPU tests hold against JAX), TF32 off:
    loss, grad norm, parameters, m and v to 1e-4 of each tensor's largest
    magnitude (`_held`); then microbatches=2 against 1 (1e-5) and remat
    against none (1e-6) on the card."""
    from repro_torch.models.module import tree_map
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    cfg = dataclasses.replace(reduce_config(ARCHS["llama3.2-3b"]),
                              dtype=torch.float32)
    params = init_from_specs(zoo.build_param_specs(cfg), 0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
             for k in ("tokens", "labels")}
    opt = AdamWConfig(warmup_steps=1, total_steps=10)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        on_card = {}
        for mb, remat in ((1, True), (2, True), (1, False)):
            scfg = TrainStepConfig(microbatches=mb, remat=remat, opt=opt)
            on_card[mb, remat] = _train_once(
                cfg, tree_map(lambda p: p.to(cuda), params),
                {k: v.to(cuda) for k, v in batch.items()}, scfg)
        cpu = _train_once(cfg, params, batch,
                          TrainStepConfig(remat=True, opt=opt))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    _held(on_card[1, True], cpu, 1e-4)
    _held(on_card[2, True], on_card[1, True], 1e-5)
    _held(on_card[1, False], on_card[1, True], 1e-6)


def test_train_step_launches_no_kernel(cuda):
    """The training path is the plain layers (the kernels have no
    backward): a bf16 step on the card launches none of the port's
    kernels, and its loss and every updated leaf are finite."""
    from repro_torch.models.module import tree_leaves
    from repro_torch.train.train_step import TrainStepConfig
    cfg = reduce_config(ARCHS["deepseek-moe-16b"])
    params = init_from_specs(zoo.build_param_specs(cfg), 0, device=cuda)
    toks = torch.as_tensor(normal((2, 64), 3) > 0, device=cuda).long() + 5
    every = dict(_KERNELS, serialize_prefix=serialize_prefix,
                 wavefront_scan=wavefront_scan)
    before = {k: fn.launches for k, fn in every.items()}
    p, state, m = _train_once(cfg, params, {"tokens": toks, "labels": toks},
                              TrainStepConfig(grad_compress=True))
    torch.cuda.synchronize()
    assert {k: fn.launches - before[k] for k, fn in every.items()} == \
        dict.fromkeys(every, 0)
    assert bool(torch.isfinite(m["loss"])) and float(m["loss"]) > 0
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves({"p": p, **state}))


def test_logits_f32_gradient_on_the_card(cuda):
    """The bf16 product with float32 output has a backward pass: its
    gradients equal the float32-operand product's within bf16 rounding
    (the output gradient is rounded to bf16 once, as the TPU's default
    precision does, and each gradient once more): 1e-2 of the largest
    magnitude, about two bf16 ulps of it."""
    x = _on(cuda, normal((64, 128), 1), "bfloat16").requires_grad_()
    w = _on(cuda, normal((500, 128), 2, 0.05), "bfloat16").requires_grad_()
    g = _on(cuda, normal((64, 500), 3), "float32")
    out = logits_f32(x, w)
    assert out.dtype == torch.float32
    gx, gw = torch.autograd.grad(out, (x, w), g)
    xf = x.detach().float().requires_grad_()
    wf = w.detach().float().requires_grad_()
    fx, fw = torch.autograd.grad(xf @ wf.t(), (xf, wf), g)
    assert gx.dtype == gw.dtype == torch.bfloat16
    assert _rel(gx, fx) <= 1e-2 and _rel(gw, fw) <= 1e-2, \
        (_rel(gx, fx), _rel(gw, fw))


# ---- the plain blocked attention on tensor cores ----------------------------

# (B, S, Hq, Hkv, D, Dv, block_q, block_kv, scale): MLA's prefill on a card
# of four (32 heads, qk 192, v 128, blocks 512 x 1024, the YaRN temperature
# over sqrt(192): 6 of 8 block pairs), and GQA with 4 query heads a KV head,
# S ragged against both blocks
BLOCKED = {
    "mla": (1, 2048, 32, 32, 192, 128, 512, 1024,
            mla_temperature({"type": "yarn", "factor": 40,
                             "mscale_all_dim": 0.707}) / math.sqrt(192)),
    "gqa": (2, 1000, 16, 4, 128, 128, 256, 512, None),
}


class _Bmms(TorchDispatchMode):
    """The operand dtypes of every `bmm` dispatched."""

    def __init__(self):
        super().__init__()
        self.dtypes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.bmm:
            self.dtypes.append((args[0].dtype, args[1].dtype))
        return func(*args, **(kwargs or {}))


def _blocked_inputs(cuda, name):
    B, S, Hq, Hkv, D, Dv, bq, bk, scale = BLOCKED[name]
    q, k, v = (_on(cuda, normal(shape, i), "bfloat16") for i, shape in
               enumerate(((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, Dv))))
    return (q, k, v), dict(block_q=bq, block_kv=bk, scale=scale)


@pytest.mark.parametrize("name", sorted(BLOCKED))
def test_blocked_attention_bf16_products_equal_float32_operands(cuda, name):
    """On the card both products take bf16 operands (float32 sums and
    output); the CPU computes the same function on float32 operands, which
    hold the bf16 values exactly.  Only the order of sums differs.  Both
    round p to bf16 before the second product and the output once, so
    where the order of sums moves a value across a rounding boundary, an
    output moves by up to a bf16 ulp of a value of v (rows that attend to
    a few keys): at most 2^-8 of the largest magnitude, 1e-4 on average
    (measured on an H100: 0.1-0.2% of the outputs differ, by at most
    0.0039)."""
    (q, k, v), kw = _blocked_inputs(cuda, name)
    with _Bmms() as bmms:
        got = layers.blocked_attention(q, k, v, **kw)
    assert bmms.dtypes and set(bmms.dtypes) == {(torch.bfloat16,) * 2}
    want = layers.blocked_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
    assert got.dtype == want.dtype == torch.bfloat16
    got, want = got.cpu().float(), want.float()
    mean = float((got - want).abs().mean() / want.abs().mean())
    assert _rel(got, want) <= 2 ** -8 and mean <= 1e-4, \
        (_rel(got, want), mean)


@pytest.mark.parametrize("name", sorted(BLOCKED))
def test_blocked_attention_gradient_on_the_card(cuda, name):
    """The bf16 products' backward (`layers._MatmulF32`, the head's
    too) against the float32-operand products' gradients: within bf16
    rounding, 1e-2 of the largest magnitude."""
    (q, k, v), kw = _blocked_inputs(cuda, name)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = layers.blocked_attention(*leaves, **kw)
    g = _on(cuda, normal(out.shape, 7), "bfloat16")
    grads = torch.autograd.grad(out, leaves, g)
    floats = [t.detach().float().requires_grad_() for t in leaves]
    want = torch.autograd.grad(layers.blocked_attention(*floats, **kw),
                               floats, g.float())
    rel = [_rel(a, b) for a, b in zip(grads, want)]
    assert all(a.dtype == torch.bfloat16 for a in grads)
    assert max(rel) <= 1e-2, rel
