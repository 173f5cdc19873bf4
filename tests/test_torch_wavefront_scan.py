"""The GA prefilter's scan over wavefronts (`repro_torch.kernels.ref.
wavefront_scan_ref`) and the wrapper of its CUDA kernel
(`repro_torch.kernels.wavefront.wavefront_scan`), on the CPU.

The fitness of the port's fused route is held against the JAX package's
`BatchedFitness` (serialize contention, its `serialize_prefix_ref` route) on
genomes made with numpy, at the tolerance of `test_torch_vectorized.py`
(rtol 1e-5: the two packages sum in different orders), across architectures
with and without channel transfers, both priorities, the three segment
modes and the spill model on and off.  On the CPU every route runs the same
plain loop, so the routes agree bit for bit.  The kernel itself is held on
the card by `tests/test_torch_cuda.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_inputs import RTOL, population
from _torch_parity import engines

from repro.core.vectorized import BatchedFitness as RefBatchedFitness

from repro_torch.core.vectorized import BatchedFitness
from repro_torch.kernels import build
from repro_torch.kernels import wavefront as wfm
from repro_torch.kernels.ref import (population_last, segments_ref,
                                     serialize_prefix_ref,
                                     wavefront_scan_ref)

torch.set_num_threads(2)

ARCHS = ["mc_hetero", "mc_hom_tpu_chip4", "diana", "aimc_4x4", "depfin"]
# (priority, segment mode, spill model): each value of each option, and
# every segment mode with the spill model on and off
CASES = [("latency", "greedy", True), ("memory", "greedy", False),
         ("latency", "strict", True), ("memory", "strict", False),
         ("memory", "none", True), ("latency", "none", False)]
SEGMENT_KW = {"greedy": {}, "strict": {"strict_layers": True},
              "none": {"segment": False}}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    ref, port = engines(request.param)
    return ref, port, population(ref.cost_model.workload, ref.accelerator,
                                 12, seed=4, spread=True)


@pytest.mark.parametrize("priority,segment,spills", CASES)
def test_fused_route_scores_match_reference(pair, priority, segment,
                                            spills):
    ref, port, pop = pair
    kw = dict(priority=priority, model_spills=spills, **SEGMENT_KW[segment])
    want = RefBatchedFitness(ref, contention="serialize", use_pallas=False,
                             **kw).scores(pop)
    fused = BatchedFitness(port, contention="serialize", device="cpu", **kw)
    assert fused.route == "fused" and fused.segment_mode == segment
    got = fused.scores(pop)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # on the CPU the step route and the plain loop are the same arithmetic
    for other in (dict(kernel="step"), dict(use_kernel=False)):
        bf = BatchedFitness(port, contention="serialize", device="cpu",
                            **kw, **other)
        assert bf.route == other.get("kernel", "plain")
        assert np.array_equal(bf.scores(pop), got)


def test_segments_match_reference(pair):
    """The greedy cut of the scan's first phase against the reference's
    jitted `_segments`, exactly."""
    ref, port, pop = pair
    want = RefBatchedFitness(ref, use_pallas=False)._segments(
        jnp.asarray(pop, dtype=jnp.int32))
    g = torch.as_tensor(pop)
    _, st, _ = BatchedFitness(port, device="cpu").scan_args(g)
    got = segments_ref(g, st["layer_wb"], st["w_cap"])
    assert np.array_equal(got.numpy(), np.asarray(want))


def _scan_inputs(arch, spills=True, k=6):
    _, port = engines(arch)
    bf = BatchedFitness(port, contention="serialize", device="cpu",
                        model_spills=spills)
    pop = population(port.cost_model.workload, port.accelerator, k, seed=2)
    g = torch.as_tensor(pop)
    return bf, g, *bf.scan_args(g)


@pytest.mark.parametrize("arch", ["mc_hom_tpu_chip4", "diana"])
def test_wrapper_on_cpu_counts_no_launch_and_is_the_plain_scan(arch):
    bf, g, xs, st, kw = _scan_inputs(arch)
    before = wfm.wavefront_scan.launches
    got = wfm.wavefront_scan(g, xs, st, **kw)
    assert wfm.wavefront_scan.launches == before
    want = wavefront_scan_ref(
        g, xs, st, serialize=population_last(serialize_prefix_ref), **kw)
    P, n, C, H = g.shape[0], bf.n, bf.n_cores, max(bf.n_chan, 1)
    shapes = [(n + 1, P), (C, P), (H, P), (P,), (n + 1, P), (P,)]
    assert [tuple(t.shape) for t in got] == shapes
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,spills", [("mc_hom_tpu_chip4", True),
                                         ("mc_hom_tpu_chip4", False),
                                         ("diana", True), ("diana", False)])
def test_pack_lays_out_genome_major_records(arch, spills):
    bf, g, xs, st, _ = _scan_inputs(arch, spills)
    L, W, P = xs["cyc"].shape
    C, D = bf.n_cores, bf.dmax
    comm = "cross" in xs
    assert comm == bf.comm and ("ac" in xs) == spills
    H = bf.n_chan if comm else 0
    k = wfm.pack(g, xs, st)
    r = wfm.record_layout(W, C, H, D, comm, spills)
    rec, srec = k["rec"], k["srec"]
    assert tuple(rec.shape) == (P, L, r["words"]) and r["words"] % 4 == 0
    assert tuple(srec.shape) == (L, r["static_words"])
    assert r["static_words"] % 4 == 0
    assert k["genomes"].dtype == torch.int32
    for t in k.values():
        assert t.is_contiguous()
    for t in (rec, srec, k["act_cap"], k["layer_wb"], k["w_cap"]):
        assert t.dtype == torch.float32
    ints, data = rec.view(torch.int32), rec.view(torch.uint8)

    def field(key, size, view=rec):
        return view[:, :, r[key]:r[key] + size]

    assert torch.equal(field("cyc", W), xs["cyc"].permute(2, 0, 1))
    assert torch.equal(field("cw", W, ints).long(), xs["cw"].permute(2, 0, 1))
    if spills:
        for key in ("aw", "ac", "fc"):
            size = W if key == "aw" else C
            assert torch.equal(field(key, size), xs[key].permute(2, 0, 1))
        assert torch.equal(field("mw", W, ints).long(),
                           xs["mw"].permute(2, 0, 1))
    if comm:
        assert torch.equal(field("occ", H * W).reshape(P, L, H, W),
                           xs["occ"].permute(3, 0, 1, 2))
        o = 4 * r["cross"]
        assert torch.equal(data[:, :, o:o + W * D].reshape(P, L, W, D),
                           xs["cross"].permute(3, 0, 1, 2).to(torch.uint8))
    sints = srec.view(torch.int32)
    for key, name in (("wf", "wf"), ("wl", "wf_layer")):
        assert torch.equal(sints[:, r[key]:r[key] + W].long(), st[name])
    assert torch.equal(srec[:, r["dram"]:r["dram"] + W], st["dram"])
    assert torch.equal(srec[:, r["tot"]], st["tot"])
    assert torch.equal(sints[:, r["pu"]:r["pu"] + W * D].reshape(L, W, D)
                       .long(), st["pu"])


def _largest_fused_n(width=17, cores=5, chan=1, seg=31, dmax=7):
    """The most CNs whose block fits the shared memory limit."""
    lo, hi = 0, 1 << 20
    while hi - lo > 1:
        mid = (lo + hi) // 2
        fits = wfm.smem_bytes(mid, width, cores, chan, seg, dmax) <= \
            build.SMEM_LIMIT
        lo, hi = (mid, hi) if fits else (lo, mid)
    assert wfm.smem_bytes(lo, width, cores, chan, seg, dmax) <= \
        build.SMEM_LIMIT < wfm.smem_bytes(lo + 1, width, cores, chan, seg,
                                          dmax)
    return lo


@pytest.mark.parametrize("case,route", [("width 32", "fused"),
                                        ("width 33", "step"),
                                        ("smem under", "fused"),
                                        ("smem over", "step")])
def test_scan_route_boundaries(case, route):
    if case.startswith("width"):
        args = (601, int(case.split()[1]), 5, 1, 31, 7)
    else:
        n = _largest_fused_n() + (case == "smem over")
        args = (n, 17, 5, 1, 31, 7)
    assert wfm.scan_route(*args) == route


def test_the_route_mirrors_the_source():
    src = (build.CSRC / "wavefront.cu").read_text()
    assert f"constexpr int kStages = {wfm.STAGES};" in src
    assert f"constexpr int kWarp = {wfm.MAX_WIDTH};" in src
    # the genome record's fields in the source's order
    order = ["cyc", "cw", "aw", "mw", "ac", "fc", "occ", "cross"]
    r = wfm.record_layout(17, 5, 2, 7)
    assert sorted(order, key=r.get) == order
    body = src[src.index("inline RecordLayout record_layout("):]
    assert [body.index(f"r.{key} = t;") for key in order] == sorted(
        body.index(f"r.{key} = t;") for key in order)


def test_fitness_routes_and_refusals():
    _, port = engines("mc_hetero")
    assert BatchedFitness(port, device="cpu").route == "plain"   # backlog
    assert BatchedFitness(port, device="cpu", contention="serialize",
                          use_kernel=False).route == "plain"
    for bad in (dict(kernel="fused", contention="backlog"),
                dict(kernel="step", use_kernel=False,
                     contention="serialize"),
                dict(kernel="old", contention="serialize")):
        with pytest.raises(ValueError):
            BatchedFitness(port, device="cpu", **bad)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, g, xs, st, kw = _scan_inputs("mc_hetero")
    with pytest.raises(TypeError, match="cyc"):
        wfm.wavefront_scan(g, {**xs, "cyc": xs["cyc"].double()}, st, **kw)
    with pytest.raises(TypeError, match="cross"):
        wfm.wavefront_scan(g, {**xs, "cross": xs["cross"].int()}, st, **kw)
    with pytest.raises(TypeError, match="genomes"):
        wfm.wavefront_scan(g.float(), xs, st, **kw)
    with pytest.raises(ValueError, match="segment"):
        wfm.wavefront_scan(g, xs, st, **{**kw, "segment": "greedy-ish"})
    meta = {k: v.to("meta") for k, v in xs.items()}
    with pytest.raises(ValueError, match="meta"):
        wfm.wavefront_scan(g, meta, st, **kw)
