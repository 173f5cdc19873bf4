"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and `nvcc`; elsewhere they skip.  On a
machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from _torch_inputs import DEEP_BF16, RTOL, TOL, normal, population, queues

from repro_torch.api import DesignSpace, GAConfig
from repro_torch.api.session import ExplorationSession
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.configs.paper_workloads import squeezenet
from repro_torch.core import vectorized
from repro_torch.core.vectorized import BatchedFitness
from repro_torch.hw import catalog
from repro_torch.hw.catalog import mc_hetero, mc_hom_tpu_chip4
from repro_torch.kernels import ref
from repro_torch.kernels import decode_attention as decode_module
from repro_torch.kernels import flash_attention as flash_module
from repro_torch.kernels import mla_attention as mla_module
from repro_torch.kernels import moe_gemm as moe_gemm_module
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.mla_attention import mla_attention_fwd
from repro_torch.kernels import rmsnorm as rmsnorm_module
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.ref import (decode_attention_ref,
                                     flash_attention_ref,
                                     flash_attention_top_left_ref,
                                     mla_attention_ref, moe_gemm_ref, rmsnorm_ref,
                                     rwkv6_scan_ref, serialize_prefix_ref,
                                     ssd_scan_ref)
from repro_torch.kernels.rmsnorm import rmsnorm_fwd
from repro_torch.kernels import rwkv6_scan as rwkv_module
from repro_torch.kernels import ssd_scan as ssd_module
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels import wavefront as wfm
from repro_torch.kernels.wavefront import serialize_prefix, wavefront_scan
from repro_torch.models import attention as attn_module
from repro_torch.models import encdec, layers, zoo
from repro_torch.models.attention import mla_temperature
from repro_torch.models.module import init_from_specs, tree_leaves
from repro_torch.models.transformer import logits_f32
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.cuda

_KERNELS = {"rmsnorm": rmsnorm_fwd, "flash_attention": flash_attention_fwd,
            "decode_attention": decode_attention_fwd, "ssd_scan": ssd_scan,
            "rwkv6_scan": rwkv6_scan, "moe_gemm": moe_gemm,
            "mla_attention": mla_attention_fwd}
_ALL_KERNELS = dict(_KERNELS, serialize_prefix=serialize_prefix,
                    wavefront_scan=wavefront_scan)


def _launches(before=None):
    """Every kernel's launch count, or its launches since `before`."""
    now = {k: fn.launches for k, fn in _ALL_KERNELS.items()}
    return now if before is None else {k: now[k] - before[k] for k in now}


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
    assert np.all(np.isfinite(s_k)) and np.all(s_k > 0)


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
    first = fused.scores(pop)
    assert (wavefront_scan.launches - before[0],
            serialize_prefix.launches - before[1]) == (chunks, 0)
    assert np.array_equal(fused.scores(pop), first)     # run to run


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


# ---- Stream's exploration and the DSE runtime, the fitness on the card ----

def _counted_chunks(monkeypatch):
    """A list that gains (fitness, genomes, latency, energy) for each chunk
    `BatchedFitness` scores while the test runs."""
    chunks = []
    score = BatchedFitness._score

    def counted(self, genomes):
        lat, en = score(self, genomes)
        chunks.append((self, genomes, lat, en))
        return lat, en

    monkeypatch.setattr(BatchedFitness, "_score", counted)
    return chunks


def _hold_chunks_against_plain(chunks):
    """Each chunk that went to `wavefront_scan`, scored again through the
    plain loop of the same fitness on the same device: latency and energy
    bit-equal, and no kernel launched."""
    before = _launches()
    for bf, genomes, lat, en in list(chunks):
        assert bf.route == "fused"
        plain = vectorized.get_batched_fitness(
            bf.engine, priority=bf.priority, segment=bf.segment,
            strict_layers=bf.strict_layers, use_kernel=False,
            contention=bf.contention, device=bf.device)
        assert plain.route == "plain"
        p_lat, p_en = plain._score(genomes)
        assert torch.equal(lat, p_lat) and torch.equal(en, p_en)
    assert not any(_launches(before).values())


def _content(record):
    """A sweep record's stored fields but its wall time."""
    d = record.to_dict()
    d.pop("runtime_s")
    return d


def test_explore_prefilters_on_the_card_one_scan_a_chunk(cuda, monkeypatch):
    """Stream's main path, `explore(prefilter=True)` with the fitness on
    the card (resnet18 on MC:Hetero, tile 32, GA pop 24 for 16
    generations): one `wavefront_scan` launch a prefilter chunk and no
    other kernel, each chunk's scores bit-equal to the plain loop's, and
    the result the exact engine's schedule of its allocation, which the
    race detector passes."""
    from repro_torch.api.session import default_session
    from repro_torch.configs.paper_workloads import resnet18
    from repro_torch.core import explore
    w, acc, gran = resnet18(), mc_hetero(), ("tile", 32, 1)
    chunks = _counted_chunks(monkeypatch)
    before = _launches()
    res = explore(w, acc, granularity=gran, pop_size=24, generations=16,
                  seed=0, prefilter=True, device=cuda)
    used = _launches(before)
    assert res.ga.prefilter_screened > 0 and chunks
    assert used == dict(dict.fromkeys(used, 0), wavefront_scan=len(chunks))
    _hold_chunks_against_plain(chunks)
    final = default_session().engine(w, acc, gran).schedule(
        res.allocation, "latency", validate=True)
    assert (res.latency_cc, res.energy_pj) == (final.latency_cc,
                                              final.energy_pj)
    assert np.isfinite(res.latency_cc) and res.latency_cc > 0


def test_prefiltered_sweep_on_the_card(cuda, monkeypatch, tmp_path):
    """The DSE runtime with the prefilter on the card: a traced serial
    `ExplorationSession.run` of 8 points of the paper's grid (squeezenet
    and mobilenetv2 on SC:TPU and MC:Hetero, layer by layer and tile 32,
    GA pop 10 for 6 generations) into a store. One `wavefront_scan`
    launch a prefilter chunk and no other kernel, each chunk bit-equal to
    the plain loop, every record the exact engine's schedule of its
    allocation; the grid with the prefilter on the plain loop stores the
    same records and tracer counters; a fresh session over the store
    schedules nothing and launches nothing."""
    from repro_torch.obs import Tracer
    space = DesignSpace(workloads=["squeezenet", "mobilenetv2"],
                        archs=[catalog.sc_tpu, catalog.mc_hetero],
                        granularities=["layer", ("tile", 32, 1)],
                        ga=GAConfig(pop_size=10, generations=6, seed=0))
    n, store = len(space), str(tmp_path / "grid")
    chunks = _counted_chunks(monkeypatch)
    tracer = Tracer()
    before = _launches()
    sweep = ExplorationSession(cache_dir=store, prefilter=True, tracer=tracer,
                               device=cuda).run(space)
    used = _launches(before)
    assert (len(sweep), sweep.n_failed, sweep.n_scheduled) == (n, 0, n)
    assert chunks and used == dict(dict.fromkeys(used, 0),
                                   wavefront_scan=len(chunks))
    _hold_chunks_against_plain(chunks)
    for point, rec in zip(space, sweep.records):
        assert rec.key == point.content_key()
        exact = ExplorationSession().evaluate_allocation(
            point.workload, point.arch, rec.allocation,
            granularity=point.granularity, priority=point.priority)
        assert (rec.latency_cc, rec.energy_pj) == (
            float(exact.latency_cc), float(exact.energy_pj))
        assert np.isfinite(rec.edp) and rec.edp > 0

    plain_tracer = Tracer()
    with monkeypatch.context() as m:
        m.setattr(vectorized, "get_batched_fitness", functools.partial(
            vectorized.get_batched_fitness, use_kernel=False))
        before = _launches()
        plain = ExplorationSession(cache_dir=str(tmp_path / "plain"),
                                   prefilter=True, tracer=plain_tracer,
                                   device=cuda).run(space)
        assert not any(_launches(before).values())
    assert [_content(r) for r in plain.records] == \
        [_content(r) for r in sweep.records]
    assert plain_tracer.snapshot()["counters"] == \
        tracer.snapshot()["counters"]

    before = _launches()
    replay = ExplorationSession(cache_dir=store, prefilter=True,
                                device=cuda).run(space)
    assert (replay.n_from_store, replay.n_scheduled) == (n, 0)
    assert not any(_launches(before).values())
    assert [_content(r) for r in replay.records] == \
        [_content(r) for r in sweep.records]


def test_process_executor_beside_the_card_equals_serial(cuda):
    """Sweep workers spawned from a process that holds a CUDA context
    store what the serial run stores (the workers run unfiltered, as the
    reference's do)."""
    torch.zeros(1, device=cuda)
    space = DesignSpace(workloads=["squeezenet"], archs=[mc_hetero],
                        granularities=["layer", ("tile", 32, 1)],
                        ga=GAConfig(pop_size=8, generations=5))
    serial = ExplorationSession().run(space)
    pooled = ExplorationSession().run(space, executor="process",
                                      max_workers=2)
    assert serial.n_failed == pooled.n_failed == 0
    assert [_content(r) for r in pooled.records] == \
        [_content(r) for r in serial.records]


def test_trace_export_with_the_fitness_on_the_card_is_deterministic(
        cuda, tmp_path):
    """`trace_export --device cuda` (the bottleneck report's lower bound
    from the batched fitness on the card) writes the same bytes twice."""
    from repro_torch.tools import trace_export
    blobs = []
    for sub in ("a", "b"):
        paths = trace_export.export_all(str(tmp_path / sub), device="cuda")
        blobs.append({name: open(p, "rb").read()
                      for name, p in paths.items()})
    assert blobs[0] == blobs[1]


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
# bf16 (8 bytes a row) and the shapes of SSD_OLD, which take the old one;
# L, P and N off the tensor cores' 16 and P off the slab of 32 (zero-padded
# tiles) included
SSD_OLD = [(1, 128, 2, 16, 8, 128), (2, 128, 8, 64, 64, 128),
           (2, 64, 3, 16, 80, 32), (1, 48, 2, 6, 8, 16)]  # L, N > 64; P = 6


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 32, 1, 8, 4, 8), (2, 64, 3, 16, 8, 16), (1, 128, 2, 32, 16, 32),
    (4, 128, 80, 64, 64, 64), (2, 64, 5, 64, 64, 64), (1, 48, 2, 8, 8, 8),
    (2, 72, 3, 48, 24, 24), (1, 80, 2, 80, 40, 40)] + SSD_OLD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_kernel_matches_plain(cuda, B, S, H, P, N, chunk, dtype,
                                       init):
    x = _on(cuda, normal((B, S, H, P), 0), dtype)
    dt = torch.nn.functional.softplus(_on(cuda, normal((B, S, H), 1),
                                          "float32"))
    A = -torch.exp(_on(cuda, normal((H,), 2, 0.5), "float32"))
    Bm = _on(cuda, normal((B, S, N), 3), dtype)
    Cm = _on(cuda, normal((B, S, N), 4), dtype)
    s0 = _on(cuda, normal((B, H, P, N), 5), "float32") if init else None
    old = (B, S, H, P, N, chunk) in SSD_OLD or (N == 4 and
                                                 dtype == "bfloat16")
    assert ssd_module.variant(x, Bm, Cm, chunk) == ("old" if old
                                                    else "tiled")
    before = ssd_scan.launches
    y, s = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=s0)
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
# slab of 32 (zero-padded tiles) included; the shapes of RWKV_OLD take the
# old kernel
RWKV_OLD = [(1, 48, 2, 16, 16, 12), (2, 128, 4, 64, 64, 64),
            (1, 64, 2, 96, 32, 16), (2, 40, 3, 16, 6, 8)]  # L, K, V


@pytest.mark.parametrize("B,S,H,K,V,chunk", [
    (1, 32, 1, 8, 8, 8), (2, 64, 3, 16, 16, 16), (1, 96, 2, 32, 16, 32),
    (4, 128, 40, 64, 64, 32), (2, 64, 3, 64, 32, 32), (2, 72, 3, 64, 48, 24),
    (1, 64, 2, 40, 80, 16)] + RWKV_OLD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("logw_case", ["some_below", "at_clip",
                                       "all_below"])
def test_rwkv6_scan_kernel_matches_plain(cuda, B, S, H, K, V, chunk, dtype,
                                         init, logw_case):
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
    old = (B, S, H, K, V, chunk) in RWKV_OLD
    assert rwkv_module.variant(r, k, v, logw, chunk) == ("old" if old
                                                         else "tiled")
    before = rwkv6_scan.launches
    o, s = rwkv6_scan(r, k, v, logw, u, chunk=chunk, initial_state=s0)
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
                                    "rwkv6_scan", "mla_attention"])
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
    elif kernel == "mla_attention":   # deepseek-v2's widths, a card's heads
        x, y, w, z = _mla_inputs(cuda, 2, 256, 32, MLA_WIDTHS)
        fn, launches = (lambda: mla_attention_fwd(x, y, w, z,
                                                  scale=MLA_SCALE)), \
            mla_attention_fwd
        assert mla_module.variant(x, y, w, z) == "mma"
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


def _kernel_and_plain_logits(cfg, params, toks, device):
    """Prefill of `toks` (B, S) into caches of S + 8 positions and one
    decode step, on the kernel path and on the plain path, with each
    kernel's launches checked: {path: (prefill, decode) logits}. Whisper
    gets seeded frame embeddings, and its decode step the encoder output of
    the same path."""
    B, S = toks.shape
    pre_n, step_n = zoo.kernel_launches(cfg)
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["enc_embeds"] = _on(device, normal(
            (B, cfg.enc["enc_len"], cfg.d_model), 14), "float32").to(
                cfg.dtype)
    out = {}
    for name, kernels in (("kernels", None), ("plain", False)):
        caches = init_from_specs(zoo.build_cache_specs(cfg, B, S + 8), 0,
                                 device=device)
        before = _launches()
        pre, caches = zoo.prefill(cfg, params, batch, caches,
                                  kernels=kernels)
        enc = None
        if cfg.family == "encdec":
            enc = encdec.encode(cfg, params, batch["enc_embeds"],
                                kernels=False)
        dec, _ = zoo.decode_step(cfg, params, pre.argmax(-1)[:, None],
                                 caches, S, enc_out=enc, kernels=kernels)
        used = _launches(before)
        want = {k: pre_n.get(k, 0) + step_n.get(k, 0) for k in used}
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


def _record_routes(monkeypatch):
    """{kernel: [variant, ...]}: the variant of every call each wrapper
    makes while the test runs, as its `variant` chooses it."""
    routes = {}
    for name, module in (("ssd_scan", ssd_module), ("rwkv6_scan", rwkv_module),
                         ("flash_attention", flash_module),
                         ("decode_attention", decode_module),
                         ("moe_gemm", moe_gemm_module),
                         ("mla_attention", mla_module)):
        def recorded(*args, _choose=module.variant, _name=name, **kw):
            route = _choose(*args, **kw)
            routes.setdefault(_name, []).append(route)
            return route
        monkeypatch.setattr(module, "variant", recorded)
    return routes


# each decoder at full width, at the depth of its float32 gate: full depth,
# or 2 layers for the two whose float32 weights do not fit one card
F32_DEPTH = {"llama3.2-3b": None, "zamba2-2.7b": None, "rwkv6-3b": None,
             "deepseek-moe-16b": None, "whisper-large-v3": None,
             "qwen2-vl-72b": 2, "deepseek-v2-236b": 2}


@pytest.mark.parametrize("arch", sorted(F32_DEPTH))
def test_kernel_path_matches_plain_path_in_float32_at_full_width(
        cuda, monkeypatch, arch):
    """Each decoder at full width and its F32_DEPTH (deepseek-moe-16b's
    float32 weights take 66 GB), seeded float32 weights, TF32 off, 4
    prompts of 128 tokens: the kernel path's prefill and first decode
    logits within 1e-3 of the plain path's, each kernel's launches as
    `zoo.kernel_launches` counts them, every scan on its tiled kernel;
    whisper's uncached forward too (encode, then the decoder stack, where
    cross attention reads the encoder output). The two paths sum float32
    in other orders: 6.1e-6 (deepseek-moe-16b) to 1.2e-4 (rwkv6-3b)
    measured on an H100, logits up to 4.8. The reduced configs of the test
    above do not show how that grows with depth."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.cuda.empty_cache()
    cfg = ARCHS[arch]
    if F32_DEPTH[arch]:
        cfg = dataclasses.replace(cfg, n_layers=F32_DEPTH[arch])
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = init_from_specs(zoo.build_param_specs(cfg),
                             torch.Generator(device=cuda).manual_seed(1),
                             device=cuda)
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        1, cfg.vocab, size=(4, 128)), device=cuda)
    routes = _record_routes(monkeypatch)
    out = _kernel_and_plain_logits(cfg, params, toks, cuda)
    if cfg.family == "encdec":
        frames = _on(cuda, normal((4, cfg.enc["enc_len"], cfg.d_model), 14),
                     "float32")
        for name, kernels in (("kernels", None), ("plain", False)):
            enc = encdec.encode(cfg, params, frames, kernels=kernels)
            hidden, _ = encdec.decode_stack(cfg, params, toks, enc,
                                            kernels=kernels)
            out[name] += (logits_f32(hidden, params["embed"]),)
    for got, want in zip(out["kernels"], out["plain"]):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-3
    for scan in ("ssd_scan", "rwkv6_scan"):
        assert set(routes.get(scan, ["tiled"])) == {"tiled"}, routes[scan]


# each decoder served at full width, deep enough for every block kind:
# zamba2-2.7b's shared attention block follows its 6th Mamba2 layer, and
# the deepseek models' first layer is dense
SERVE_DEPTH = {"llama3.2-3b": 2, "zamba2-2.7b": 6, "rwkv6-3b": 2,
               "deepseek-moe-16b": 2, "qwen2-vl-72b": 2,
               "deepseek-v2-236b": 2}
# the variant every bf16 serving call of each kernel runs
FAST = {"ssd_scan": "tiled", "rwkv6_scan": "tiled", "flash_attention": "mma",
        "decode_attention": "split", "moe_gemm": "mma", "mla_attention": "mma"}


@pytest.mark.parametrize("arch", sorted(SERVE_DEPTH))
def test_serve_engine_at_full_width_runs_the_fast_kernels(cuda, monkeypatch,
                                                          arch):
    """`ServeEngine.serve` of 8 requests through 4 slots (two waves of a
    prefill of 128-token prompts and 3 decode steps) at full width in
    bf16, seeded weights: every request done with 4 tokens in the
    vocabulary, each kernel's launches as `zoo.kernel_launches` counts
    them, and every call of every kernel its fast variant (FAST)."""
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(ARCHS[arch], n_layers=SERVE_DEPTH[arch])
    params = init_from_specs(zoo.build_param_specs(cfg),
                             torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    prompts = np.random.default_rng(5).integers(1, cfg.vocab, size=(8, 128))
    eng = ServeEngine(cfg, params, batch_slots=4, prompt_len=128,
                      max_len=168, device=cuda)
    routes = _record_routes(monkeypatch)
    before = _launches()
    reqs = eng.serve([Request(prompt=p, max_new_tokens=4) for p in prompts])
    used = _launches(before)
    pre_n, step_n = zoo.kernel_launches(cfg)
    assert used == {k: 2 * pre_n.get(k, 0) + 6 * step_n.get(k, 0)
                    for k in used}
    assert all(r.done and len(r.out_tokens) == 4 and
               all(0 <= t < cfg.vocab for t in r.out_tokens) for r in reqs)
    assert routes and all(set(v) == {FAST[k]} for k, v in routes.items()), \
        {k: sorted(set(v)) for k, v in routes.items()}


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
    from repro_torch.train.train_step import TrainStepConfig
    cfg = reduce_config(ARCHS["deepseek-moe-16b"])
    params = init_from_specs(zoo.build_param_specs(cfg), 0, device=cuda)
    toks = torch.as_tensor(normal((2, 64), 3) > 0, device=cuda).long() + 5
    before = _launches()
    p, state, m = _train_once(cfg, params, {"tokens": toks, "labels": toks},
                              TrainStepConfig(grad_compress=True))
    torch.cuda.synchronize()
    assert _launches(before) == dict.fromkeys(_ALL_KERNELS, 0)
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


def test_launch_train_on_the_card_runs_the_plain_layers(cuda, capsys):
    """`python -m repro_torch.launch.train --device cuda` (a llama of 2
    layers of width 64): the CPU run's log, ending "done", finite
    parameters on the card, and no launch of a kernel of the port (the
    kernels have no backward)."""
    from repro_torch.launch import train
    before = _launches()
    params = train.main(["--smoke", "--layers", "2", "--d-model", "64",
                         "--seq", "32", "--batch", "4", "--steps", "3",
                         "--device", "cuda"])
    torch.cuda.synchronize()
    assert not any(_launches(before).values())
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=llama3.2-3b-smoke device=cuda")
    assert [line.split()[1] for line in out[1:-1]] == ["0", "2"]
    assert out[-1] == "done"
    assert all(p.is_cuda and bool(torch.isfinite(p).all())
               for p in tree_leaves(params))


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


# ---- MLA's prefill attention kernel ---------------------------------------

MLA_WIDTHS = (128, 64, 128)          # deepseek-v2's qk_nope, qk_rope, v_dim
MLA_SCALE = BLOCKED["mla"][-1]       # its YaRN temperature over sqrt(192)


def _mla_inputs(cuda, B, S, H, widths, seed=0):
    """q (B, S, H, qk_nope + qk_rope), kn (B, S, H, qk_nope), the shared
    kr (B, S, qk_rope) and v (B, S, H, v_dim): standard normals in bf16,
    drawn on the card from a seeded generator (the cell's shape is 0.5 G
    values)."""
    dn, dr, dv = widths
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=cuda).bfloat16()
                 for shape in ((B, S, H, dn + dr), (B, S, H, dn), (B, S, dr),
                               (B, S, H, dv)))


def _mla_plain(q, kn, kr, v, scale):
    """The model's plain MLA prefill attention: per-head keys `cat`-built,
    the blocked attention in blocks of 512 x 1024, bf16 products."""
    B, T, H, _ = kn.shape
    kf = torch.cat([kn, kr[:, :, None].expand(B, T, H, kr.shape[-1])], -1)
    return layers.blocked_attention(q, kf, v, causal=True, scale=scale)


@pytest.mark.parametrize("B,S,H,widths", [
    (8, 4096, 32, MLA_WIDTHS),     # a card's layer of dsv2-tp4-prefill
    *[(2, S, 32, MLA_WIDTHS) for S in (1, 63, 64, 65, 1000)],
    (2, 65, 4, (32, 16, 32)), (3, 200, 4, (32, 16, 32))])
def test_mla_attention_kernel_matches_the_plain_path(cuda, B, S, H, widths):
    """The kernel against the model's plain path in bf16 at the same scale
    (the YaRN temperature at deepseek-v2's widths), and against the plain
    twin where its (B, H, S, S) float32 scores fit: both round p to bf16,
    each relative to its own running max, so they differ by that rounding
    and the output's."""
    q, kn, kr, v = _mla_inputs(cuda, B, S, H, widths, seed=S)
    assert mla_module.variant(q, kn, kr, v) == "mma"
    scale = MLA_SCALE if widths == MLA_WIDTHS else \
        1 / math.sqrt(widths[0] + widths[1])
    before = mla_attention_fwd.launches
    got = mla_attention_fwd(q, kn, kr, v, scale=scale)
    assert mla_attention_fwd.launches == before + 1
    want = _mla_plain(q, kn, kr, v, scale)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")
    if S <= 1000:
        _close(got, mla_attention_ref(q, kn, kr, v, scale=scale),
               "bfloat16")


@pytest.mark.parametrize("B,H", [(65535, 1), (1, 65535)])
def test_mla_attention_kernel_at_the_grids_limits(cuda, B, H):
    """65535 batches or heads, the grid's limits on its y and z axes;
    one more is refused before any launch."""
    q, kn, kr, v = _mla_inputs(cuda, B, 3, H, (32, 16, 32))
    got = mla_attention_fwd(q, kn, kr, v, scale=0.2)
    _close(got, mla_attention_ref(q, kn, kr, v, scale=0.2), "bfloat16")
    q, kn, kr, v = _mla_inputs(cuda, B + (H == 1), 1, H + (B == 1),
                               (32, 16, 32))
    before = mla_attention_fwd.launches
    with pytest.raises(ValueError, match="65535"):
        mla_attention_fwd(q, kn, kr, v, scale=0.2)
    assert mla_attention_fwd.launches == before


@pytest.mark.parametrize("case", ["float32", "widths", "q-misaligned"])
def test_mla_attention_wrapper_refuses_calls_off_its_grid(cuda, case):
    """A CUDA call the kernel does not take (float32, widths it is not
    compiled for, q off the 16-byte grid) raises before any launch, and
    never falls back to the plain version's (B, H, S, T) float32 scores:
    the model sends such a call to the blocked attention."""
    widths = (64, 32, 64) if case == "widths" else MLA_WIDTHS
    q, kn, kr, v = _mla_inputs(cuda, 2, 65, 4, widths)
    if case == "float32":
        q, kn, kr, v = (t.float() for t in (q, kn, kr, v))
    elif case == "q-misaligned":
        q = _at_offset(q, 1)
    assert mla_module.variant(q, kn, kr, v) == "plain"
    before = mla_attention_fwd.launches
    with pytest.raises(ValueError, match="blocked attention"):
        mla_attention_fwd(q, kn, kr, v, scale=0.1)
    assert mla_attention_fwd.launches == before


@pytest.mark.parametrize("dtype,widths", [("float32", MLA_WIDTHS),
                                          ("bfloat16", (16, 8, 16))])
def test_mla_prefill_off_the_kernels_grid_takes_the_blocked_path(
        cuda, monkeypatch, dtype, widths):
    """`kernels=True` on the card for a prefill the MLA kernel does not
    take (float32, or widths it is not compiled for): the model runs the
    blocked attention's plain branch on per-head keys, O(S) memory as on
    the plain path, launches no MLA kernel, and gives the plain path's
    output within the type's tolerance (the norms run the rmsnorm
    kernel)."""
    dn, dr, dv = widths
    kw = dict(n_heads=4, qk_nope=dn, qk_rope=dr, v_dim=dv, kv_lora=64)
    specs = attn_module.mla_specs(128, 4, dn, dr, dv, 64,
                                  getattr(torch, dtype))
    params = init_from_specs(specs, 0, device=cuda)
    x = _on(cuda, normal((2, 130, 128), 3), dtype)
    pos = torch.arange(130, device=cuda)[None].expand(2, 130)
    calls = []

    def blocked(*args, **kwargs):
        calls.append(kwargs.get("kernels", False))
        return layers.blocked_attention(*args, **kwargs)

    monkeypatch.setattr(attn_module, "blocked_attention", blocked)
    before = mla_attention_fwd.launches
    got, _ = attn_module.mla_attention(params, x, pos, kernels=True, **kw)
    assert mla_attention_fwd.launches == before and calls == [False]
    want, _ = attn_module.mla_attention(params, x, pos, **kw)
    _close(got, want, dtype)


# sha256 of flash_attention_kernel_mma's bf16 outputs at seeded inputs
# (numpy normals, the model's transposed views), read on an H100 from the
# kernel as it was before MLA's prefill kernel came beside it: that kernel
# and its function stay as they were, bit for bit
FLASH_DIGESTS = {
    "llama": ((4, 128, 128, 24, 8, 128, True), "c4a6d101b8716fc7"),
    "dsmoe": ((16, 2048, 2048, 16, 16, 128, True), "a53b3f981bced6e0"),
    "zamba-d80": ((4, 128, 128, 32, 32, 80, True), "745e7e6aa0f3cf8d"),
    "whisper-cross": ((4, 128, 1500, 20, 20, 64, False), "8bdba3532be32187"),
    "s-not-t": ((2, 128, 168, 24, 8, 128, True), "82bf97d9143147f4")}


@pytest.mark.parametrize("name", sorted(FLASH_DIGESTS))
def test_flash_attention_mma_outputs_are_unchanged(cuda, name):
    import hashlib
    (B, S, T, Hq, Hkv, D, causal), digest = FLASH_DIGESTS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                               device=cuda).bfloat16().transpose(1, 2)
               for s in ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    assert flash_module.variant(q, k, v) == "mma"
    out = flash_attention_fwd(q, k, v, causal=causal)
    got = hashlib.sha256(out.contiguous().view(torch.int16).cpu().numpy()
                         .tobytes()).hexdigest()
    assert got[:16] == digest


def test_mla_prefill_counts_its_tiles_while_a_profiler_records(cuda):
    """A prefill of the reduced deepseek-v2 (2 layers, S 130: 6 of 9 tiles
    of 64 x 64) on the kernel path under torch.profiler counts the
    kernel's tiles and no block pair of the plain attention."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.realtime import DEVICE_TRACER
    cfg = reduce_config(ARCHS["deepseek-v2-236b"])
    params = init_from_specs(zoo.build_param_specs(cfg), 0, device=cuda)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 130)), device=cuda)
    caches = init_from_specs(zoo.build_cache_specs(cfg, 2, 138), 0,
                             device=cuda)
    before = dict(DEVICE_TRACER.snapshot()["counters"])
    with profile(activities=[ProfilerActivity.CPU]):
        zoo.prefill(cfg, params, {"tokens": toks}, caches)
    after = DEVICE_TRACER.snapshot()["counters"]
    grew = {k: after.get(k, 0.0) - before.get(k, 0.0)
            for k in ("attn.mla_tiles", "attn.mla_tiles_skipped",
                      "attn.block_pairs")}
    assert grew == {"attn.mla_tiles": 12.0, "attn.mla_tiles_skipped": 6.0,
                    "attn.block_pairs": 0.0}


# ---- the multi-device layer on one rank, and the dry run, on the card -----

def test_one_nccl_rank_serves_as_the_engine_without_a_mesh(cuda, monkeypatch,
                                                           tmp_path):
    """The multi-device layer over a one-rank NCCL process group (a file://
    store) under `make_host_mesh()`, a (1, 1) mesh on the card:
    `ServeEngine(mesh=)` serves the mesh-free engine's tokens with each
    kernel's launches, holding the caller's parameters; split-KV decode
    gives the plain decode's float32 logits; `moe_ffn(mesh=)` equals the
    mesh-free call bit for bit through three tensor-core `moe_gemm`
    launches; the production mesh refuses one rank."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models.layers import moe_ffn, moe_specs
    from repro_torch.sharding.rules import local_specs
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(device_type="cuda")
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.device_mesh is not None
        with pytest.raises(ValueError):
            make_production_mesh(device_type="cuda")

        cfg = reduce_config(ARCHS["llama3.2-3b"])
        params = init_from_specs(zoo.build_param_specs(cfg), 0, device=cuda)
        prompts = np.random.default_rng(5).integers(1, cfg.vocab,
                                                    size=(8, 32))
        served = {}
        for name, m in (("plain", None), ("mesh", mesh)):
            eng = ServeEngine(cfg, params, mesh=m, batch_slots=4,
                              prompt_len=32, max_len=40, device=cuda)
            assert eng.params["embed"] is params["embed"]
            before = _launches()
            reqs = eng.serve([Request(prompt=p, max_new_tokens=4)
                              for p in prompts])
            served[name] = ([r.out_tokens for r in reqs], _launches(before))
        assert served["mesh"] == served["plain"]
        assert any(served["mesh"][1].values())

        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        params = init_from_specs(zoo.build_param_specs(f32), 1, device=cuda)
        logits = {}
        for kv in (True, False):
            caches = init_from_specs(local_specs(
                zoo.build_cache_specs(f32, 4, 40),
                zoo.cache_shardings(f32, 4, 40, mesh, kv)), 0, device=cuda)
            lg, caches = zoo.prefill(f32, params, {"tokens": torch.as_tensor(
                prompts[:4], device=cuda)}, caches, mesh=mesh,
                kv_seq_shard=kv)
            steps = [lg]
            for t in range(4):
                lg, caches = zoo.decode_step(
                    f32, params, steps[-1].argmax(-1)[:, None], caches,
                    32 + t, mesh=mesh, kv_seq_shard=kv)
                steps.append(lg)
            logits[kv] = steps
        for a, b in zip(logits[True], logits[False]):
            assert float((a - b).abs().max()) <= 1e-3

        moe_cfg = reduce_config(ARCHS["deepseek-moe-16b"])
        mo = moe_cfg.moe
        moe_params = init_from_specs(
            moe_specs(moe_cfg.d_model, mo["d_ff_expert"], mo["n_routed"],
                      mo["n_shared"], moe_cfg.dtype), 2, device=cuda)
        x = _on(cuda, normal((4, 32, moe_cfg.d_model), 3), "bfloat16")
        kw = dict(top_k=mo["top_k"],
                  capacity_factor=mo.get("capacity_factor", 1.25))
        routes = _record_routes(monkeypatch)
        before = moe_gemm.launches
        got, aux = moe_ffn(moe_params, x, mesh=mesh, kernels=True, **kw)
        assert moe_gemm.launches - before == 3
        assert routes["moe_gemm"] == ["mma"] * 3
        want, want_aux = moe_ffn(moe_params, x, kernels=True, **kw)
        assert torch.equal(got, want) and float(aux) == float(want_aux)
        plain, _ = moe_ffn(moe_params, x, mesh=mesh, kernels=False, **kw)
        assert float((got.float() - plain.float()).abs().max()) <= \
            2e-2 * max(1.0, float(plain.float().abs().max()))
    finally:
        dist.destroy_process_group()


def test_dry_run_counts_the_train_step_it_predicts_on_the_card(cuda,
                                                               monkeypatch):
    """The dry run (fake tensors, an abstract (1, 1) mesh) against the same
    train step on the card: llama3.2-3b at full width and 2 layers, B 2 x
    S 512, full remat. Its FLOPs within 1% of `dryrun.flop_counter`'s over
    the real step, its argument bytes within 1% of the memory the
    parameters, the AdamW state and the batch take on the card, and no
    launch of a kernel of the port on either side."""
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.sharding.rules import Mesh
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)
    arch, shape = "llama3.2-3b", ShapeConfig("train_b2_s512", "train", 512, 2)
    cfg = dataclasses.replace(ARCHS[arch], n_layers=2)
    monkeypatch.setitem(ARCHS, arch, cfg)
    monkeypatch.setitem(SHAPES, shape.name, shape)
    one = Mesh.abstract((1, 1), ("data", "model"), device_type="cuda")
    before = _launches()
    _, dry = dryrun.lower_cell(arch, shape.name, multi_pod=False, mesh=one,
                               device="cuda")
    step_cfg = TrainStepConfig(remat=True, opt=AdamWConfig())
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = init_from_specs(zoo.build_param_specs(cfg), 0, device=cuda)
    state = init_train_state(cfg, params, step_cfg)
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                                  global_batch=shape.global_batch))
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in data.global_batch(0).items()}
    torch.cuda.synchronize()
    card_bytes = torch.cuda.memory_allocated() - base
    counter = dryrun.flop_counter()
    with counter:
        _, _, m = make_train_step(cfg, one, step_cfg)(params, state, batch)
    assert np.isfinite(float(m["loss"]))
    assert not any(_launches(before).values())
    flops = dry["roofline"]["flops"] / counter.get_total_flops()
    args = dry["memory"]["argument_size_bytes"] / card_bytes
    assert abs(flops - 1) <= 0.01 and abs(args - 1) <= 0.01, (flops, args)
