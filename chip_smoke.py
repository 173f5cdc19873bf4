"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    PYTHONPATH=src python3 chip_smoke.py

Phases, one JSON line each; the first failure raises, so the script exits
non-zero and prints no `ok` line:

1. device  — the card (`nvidia-smi`), torch and CUDA versions;
2. build   — every kernel under src/repro_torch/kernels/csrc, one nvcc per
             source, all started together;
3. kernel  — each kernel against its plain PyTorch version on the card;
4. fitness — BatchedFitness on the card, kernel path against the plain path
             and against the CPU, launch counts, genomes/s, kernel times;
5. explore — Stream's explore(prefilter=True) on the card, the main path,
             with every launch count set to 0 just before it.

Then a line `{"kernels": [...]}`, the `nvidia-smi` name and power limit, and
last `{"ok": true, "device": {...}}`.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

GRAN = ("tile", 32, 1)
RTOL = 1e-5                      # as the reference's kernel-vs-jnp tests
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # H100 SXM data sheet, float32 non-tensor
KERNEL_SHAPES = [(1, 1), (5, 7), (1280, 17), (2048, 28), (40, 33), (300, 257),
                 (160, 17), (32, 17)]
TIMED_SHAPES = [(1280, 17), (2048, 28)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean ms per call of `fn` over `iters` back-to-back calls, by CUDA
    events on the current stream."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queues(rng, rows: int, w: int, device):
    """Random FCFS queues with about a quarter of the items off the queue
    (d = 0, r = -1e30), as the fitness path encodes them."""
    import torch
    free0 = rng.uniform(0, 50, size=rows).astype(np.float32)
    release = rng.uniform(0, 100, size=(rows, w)).astype(np.float32)
    dur = rng.uniform(0, 10, size=(rows, w)).astype(np.float32)
    off = rng.random((rows, w)) < 0.25
    release[off] = -1e30
    dur[off] = 0.0
    return tuple(torch.as_tensor(a, device=device)
                 for a in (free0, release, dur))


def serialize_bound(rows: int, w: int) -> tuple[float, str]:
    """Least time for one launch: each input read once (free0, release,
    dur), each output written once (fin, new_free); about 6 float32
    operations per item (prefix sum, g, prefix max, max with free0, fin)."""
    t_bytes = rows * (8 + 12 * w) / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * rows * w / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_times(fn) -> tuple[float, list]:
    """Run `fn` once under torch.profiler: (wall ms, [(device us, kernel
    name, count)] over the device kernels, largest first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is not None and \
                "CUDA" not in str(ev.device_type):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    return wall * 1e3, rows


def kernel_device_ms(fn, name: str, iters: int = 100) -> float | None:
    """Mean device ms of the kernels whose name holds `name`, over `iters`
    calls of `fn` (None when the profiler sees no such kernel)."""
    _, rows = device_times(lambda: [fn() for _ in range(iters)])
    hits = [(us, c) for us, k, c in rows if name in k]
    if not hits:
        return None
    return sum(us for us, _ in hits) / 1e3 / sum(c for _, c in hits)


def profile_scores(bf, pop) -> dict:
    """Where one scores() call spends its time on the card: wall time, the
    device's busy time (sum of kernel times) and its idle share, and the
    kernels with the most device time."""
    device_times(lambda: bf.scores(pop))        # the profiler's own warm-up
    wall_ms, rows = device_times(lambda: bf.scores(pop))
    kernels = [r for r in rows if not r[1].startswith("aten::")]
    busy_ms = sum(r[0] for r in kernels) / 1e3
    ser = [r for r in kernels if "serialize_prefix" in r[1]]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if kernels else None,
            "kernel_launches": sum(r[2] for r in kernels),
            "serialize_device_ms": sum(r[0] for r in ser) / 1e3,
            "serialize_count": sum(r[2] for r in ser),
            "top": [{"name": k[:90], "device_ms": us / 1e3, "count": c}
                    for us, k, c in kernels[:8]]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.api.session import default_session
    from repro_torch.configs.paper_workloads import resnet18, squeezenet
    from repro_torch.core import explore
    from repro_torch.core.allocator import feasible_cores_per_layer
    from repro_torch.core.vectorized import BatchedFitness, rank_correlation
    from repro_torch.hw.catalog import mc_hetero, mc_hom_tpu_chip4
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import serialize_prefix_ref
    from repro_torch.kernels.wavefront import serialize_prefix

    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ---- build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.build_seconds,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "Used" in ln or "spill" in ln]
                    for k, v in build.ptxas_info.items()},
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()}})

    # ---- kernel vs plain on the card --------------------------------------
    rng = np.random.default_rng(0)
    max_abs = max_rel = 0.0
    for rows, w in KERNEL_SHAPES:
        free0, release, dur = queues(rng, rows, w, dev)
        fin_k, free_k = serialize_prefix(free0, release, dur)
        fin_p, free_p = serialize_prefix_ref(free0, release, dur)
        torch.cuda.synchronize()
        for got, want in ((fin_k, fin_p), (free_k, free_p)):
            torch.testing.assert_close(got, want, rtol=RTOL, atol=0.0)
            err = (got - want).abs()
            max_abs = max(max_abs, float(err.max()))
            max_rel = max(max_rel, float((err / want.abs()).max()))
    times = {}
    for rows, w in TIMED_SHAPES:
        free0, release, dur = queues(rng, rows, w, dev)
        times[(rows, w)] = {
            "ms": cuda_ms(lambda: serialize_prefix(free0, release, dur)),
            "plain_ms": cuda_ms(
                lambda: serialize_prefix_ref(free0, release, dur)),
            "device_ms": kernel_device_ms(
                lambda: serialize_prefix(free0, release, dur),
                "serialize_prefix"),
            "bound": serialize_bound(rows, w)}
    emit({"phase": "kernel", "name": "serialize_prefix",
          "shapes": KERNEL_SHAPES, "rtol": RTOL, "max_abs_err": max_abs,
          "max_rel_err": max_rel,
          "times": {f"{r}x{w}": {"ms": v["ms"], "device_ms": v["device_ms"],
                                 "plain_ms": v["plain_ms"],
                                 "bound_ms": v["bound"][0]}
                    for (r, w), v in times.items()}})

    # ---- batched fitness on the card --------------------------------------
    session = default_session()
    for w, acc in ((resnet18(), mc_hetero()),
                   (squeezenet(), mc_hom_tpu_chip4())):
        engine = session.engine(w, acc, GRAN)
        feas = feasible_cores_per_layer(w, acc)
        grng = np.random.default_rng(1)
        pop = np.stack([[f[grng.integers(len(f))] for f in feas]
                        for _ in range(256)])
        kern = BatchedFitness(engine, device=dev)
        plain = BatchedFitness(engine, device=dev, use_kernel=False)
        assert kern.contention == "serialize" and kern.use_kernel
        per_chunk = kern.n_wavefronts * (2 if kern.comm else 1)
        kern.scores(pop)                                  # warm-up
        plain.scores(pop)
        serialize_prefix.launches = 0
        t0 = time.perf_counter()
        s_k = kern.scores(pop)
        t_k = time.perf_counter() - t0
        launches = serialize_prefix.launches
        n_chunks = -(-len(pop) // kern.chunk_size(len(pop)))
        assert launches == per_chunk * n_chunks, (launches, per_chunk)
        t0 = time.perf_counter()
        s_p = plain.scores(pop)
        t_p = time.perf_counter() - t0
        np.testing.assert_allclose(s_k, s_p, rtol=RTOL)
        cpu = BatchedFitness(engine, device="cpu", contention="serialize")
        s_c = cpu.scores(pop[:16])
        np.testing.assert_allclose(s_k[:16], s_c, rtol=RTOL)
        assert np.all(np.isfinite(s_k)) and np.all(s_k > 0)
        t0 = time.perf_counter()
        exact = engine.evaluate_population(pop, "latency")
        t_e = time.perf_counter() - t0
        try:
            prof = profile_scores(kern, pop)
        except Exception as exc:   # the profiler is a measurement aid only
            prof = {"error": repr(exc)}
        emit({"phase": "fitness", "workload": w.name, "arch": acc.name,
              "genomes": len(pop), "cns": engine.graph.n,
              "wavefronts": kern.n_wavefronts, "width": kern.width,
              "cores": kern.n_cores, "channels": kern.n_chan,
              "launches": launches, "expected_launches": per_chunk * n_chunks,
              "kernel_genomes_per_s": len(pop) / t_k,
              "plain_genomes_per_s": len(pop) / t_p,
              "exact_genomes_per_s": len(pop) / t_e,
              "max_rel_kernel_vs_plain": float(np.max(np.abs(s_k - s_p)
                                                      / np.abs(s_p))),
              "rank_corr_latency": rank_correlation(s_k[:, 0], exact[:, 0]),
              "rank_corr_energy": rank_correlation(s_k[:, 1], exact[:, 1]),
              "profile": prof})

    # ---- the main path: explore(prefilter=True) on the card ---------------
    w, acc = resnet18(), mc_hetero()
    kw = dict(granularity=GRAN, pop_size=24, generations=16, seed=0)
    serialize_prefix.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = explore(w, acc, prefilter=True, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = serialize_prefix.launches
    assert res.ga.prefilter_screened > 0, res.ga
    assert launches > 0, "explore never launched the serialize kernel"
    final = session.engine(w, acc, GRAN).schedule(res.allocation, "latency")
    assert (res.latency_cc, res.energy_pj) == (final.latency_cc,
                                              final.energy_pj)
    assert np.isfinite(res.latency_cc) and res.latency_cc > 0
    t0 = time.perf_counter()
    base = explore(w, acc, prefilter=False, **kw)
    wall_base = time.perf_counter() - t0
    emit({"phase": "explore", "workload": w.name, "arch": acc.name,
          "granularity": list(GRAN), "wall_s": wall,
          "unfiltered_wall_s": wall_base, "launches": launches,
          "prefilter_screened": res.ga.prefilter_screened,
          "prefilter_pruned": res.ga.prefilter_pruned,
          "evaluations": res.ga.evaluations,
          "unfiltered_evaluations": base.ga.evaluations,
          "latency_cc": res.latency_cc, "energy_pj": res.energy_pj,
          "allocation_equals_unfiltered": bool(
              np.array_equal(res.allocation, base.allocation))})

    t = times[TIMED_SHAPES[0]]
    emit({"kernels": [{
        "name": "serialize_prefix", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wavefront.cu",
        "replaces": "src/repro/kernels/wavefront.py:37",
        "launches": launches, "max_abs_err": max_abs,
        "ms": t["ms"], "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1], "library_ms": None,
        "shape": list(TIMED_SHAPES[0])}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
