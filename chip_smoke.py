"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    PYTHONPATH=src python3 chip_smoke.py

Phases, one JSON line each; the first failure raises, so the script exits
non-zero and prints no `ok` line:

1. device  — the card (`nvidia-smi`), torch and CUDA versions;
2. build   — every kernel under src/repro_torch/kernels/csrc, one nvcc per
             source, all started together, with ptxas' registers and spills;
3. kernel  — each kernel against its plain PyTorch version on the card
             (serialize_prefix, rmsnorm, decode_attention, flash_attention),
             with its times at the main path's shapes, its bound and the
             time of one PyTorch call computing the same function;
4. fitness — BatchedFitness on the card, kernel path against the plain path
             and against the CPU, launch counts, genomes/s, kernel times;
5. explore — Stream's explore(prefilter=True) on the card, the DSE main
             path, with every launch count set to 0 just before it;
6. serve   — llama3.2-3b at full width (seeded random weights on the card)
             through ServeEngine.serve, the serving main path, with every
             launch count set to 0 just before it; then the kernel path
             against the plain path (kernels=False) on the same weights.

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
BF16_OPS_PER_S = 989e12          # H100 SXM data sheet, dense bf16 tensor
# kernel-vs-plain tolerances of the reference's kernel tests
# (tests/test_kernels.py:17-19)
SERVE_TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# The serving main path: llama3.2-3b at full width under
# ServeEngine(batch_slots=4, prompt_len=128, max_len=168), 8 requests of
# 32 new tokens, so two FIFO waves of one prefill and 31 decode steps.
ARCH = "llama3.2-3b"
SLOTS, PROMPT, MAX_LEN, NEW, N_REQ = 4, 128, 168, 32, 8
WAVES = N_REQ // SLOTS
DECODE_STEPS = WAVES * (NEW - 1)
# the middle of a wave's decode steps, which attend over 129..159 positions
SERVE_CUR = PROMPT + NEW // 2
# the plain path's prefill logits may differ from the kernel path's by the
# kernels' documented roundings (p in float32, one rounding of the norm)
# carried through 28 layers: 0.0506 measured on an H100 (see PERF.md),
# so the limit is about twice that
LOGITS_TOL = 0.1
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


# ---- the serving kernels ---------------------------------------------------

def tensor(rng, shape, dtype, dev):
    """Standard normals from a numpy generator, as a tensor on `dev`."""
    import torch
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.as_tensor(a, device=dev).to(getattr(torch, dtype))


def held(got, want, dtype) -> float:
    """Max abs error of a kernel's output against its plain version; raises
    beyond the reference's kernel tolerance."""
    import torch
    tol = SERVE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    return float((got.float() - want.float()).abs().max())


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    """The least time for the work, ms: bytes over the memory rate or
    operations over the peak rate for their type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(kern, plain, library, name: str, work) -> dict:
    """Events ms of the kernel's wrapper, the profiler's device ms of its
    kernel, the plain version's and the library call's events ms, and the
    bound of the work."""
    b = bound(*work)
    return {"ms": cuda_ms(kern), "device_ms": kernel_device_ms(kern, name),
            "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
            "bound_ms": b[0], "bound_by": b[1]}


def check_rmsnorm(dev) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import rmsnorm_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd
    rng = np.random.default_rng(2)
    errs = {}
    for shape in [(SLOTS, 1, 3072), (SLOTS, PROMPT, 3072), (4, 37, 96),
                  (1, 300, 64)]:
        for dtype in ("float32", "bfloat16"):
            for sdtype in sorted({dtype, "float32"}):
                x = tensor(rng, shape, dtype, dev)
                s = tensor(rng, shape[-1:], sdtype, dev)
                errs[f"{shape}-{dtype}-{sdtype}"] = held(
                    rmsnorm_fwd(x, s), rmsnorm_ref(x, s), dtype)
    times = {}
    for rows in (SLOTS, SLOTS * PROMPT):     # a decode step, a prefill
        x = tensor(rng, (rows, 3072), "bfloat16", dev)
        s = tensor(rng, (3072,), "bfloat16", dev)
        n_bytes = 2 * x.numel() * 2 + s.numel() * 2
        times[rows] = timed(lambda: rmsnorm_fwd(x, s),
                            lambda: rmsnorm_ref(x, s),
                            lambda: F.rms_norm(x, (3072,), s, 1e-5),
                            "rmsnorm_kernel",
                            (n_bytes, 4 * x.numel(), F32_OPS_PER_S))
        times[rows]["max_abs_err"] = held(rmsnorm_fwd(x, s),
                                          rmsnorm_ref(x, s), "bfloat16")
    return {"errors": errs, "times": times, "main": times[SLOTS],
            "shape": [SLOTS, 3072]}


def _kv(rng, layout, B, Hkv, T, D, dtype, dev):
    """k, v as (B, Hkv, T, D): contiguous (the TPU kernel's layout, G = 1)
    or transposed views of the model's (B, T, Hkv, D) cache."""
    if layout == "model":
        return [tensor(rng, (B, T, Hkv, D), dtype, dev).transpose(1, 2)
                for _ in range(2)]
    return [tensor(rng, (B, Hkv, T, D), dtype, dev) for _ in range(2)]


def check_decode_attention(dev) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.ref import decode_attention_ref
    rng = np.random.default_rng(3)
    errs = {}
    for layout, hq, hkv in (("tpu", 8, 8), ("model", 24, 8)):
        for B, T, D in ((SLOTS, MAX_LEN, 128), (2, 200, 64), (3, 64, 128)):
            for cur in (1, 100, T):
                for dtype in ("float32", "bfloat16"):
                    q = tensor(rng, (B, hq, D), dtype, dev)
                    k, v = _kv(rng, layout, B, hkv, T, D, dtype, dev)
                    errs[f"{layout}-{B}x{T}x{D}-cur{cur}-{dtype}"] = held(
                        decode_attention_fwd(q, k, v, cur),
                        decode_attention_ref(q, k, v, cur), dtype)
    q = tensor(rng, (SLOTS, 24, 128), "bfloat16", dev)
    k, v = _kv(rng, "model", SLOTS, 8, MAX_LEN, 128, "bfloat16", dev)
    mask = torch.arange(MAX_LEN, device=dev) < SERVE_CUR
    n_bytes = 2 * q.numel() * 2 + 2 * SLOTS * 8 * SERVE_CUR * 128 * 2
    t = timed(lambda: decode_attention_fwd(q, k, v, SERVE_CUR),
              lambda: decode_attention_ref(q, k, v, SERVE_CUR),
              lambda: F.scaled_dot_product_attention(
                  q[:, :, None], k, v, attn_mask=mask[None],
                  enable_gqa=True),
              "decode_attention_kernel",
              (n_bytes, 4 * SLOTS * 24 * SERVE_CUR * 128, BF16_OPS_PER_S))
    t["max_abs_err"] = held(decode_attention_fwd(q, k, v, SERVE_CUR),
                            decode_attention_ref(q, k, v, SERVE_CUR),
                            "bfloat16")
    return {"errors": errs, "main": t,
            "shape": [SLOTS, 24, 8, MAX_LEN, 128, SERVE_CUR]}


def check_flash_attention(dev) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import flash_attention_ref
    rng = np.random.default_rng(4)
    errs = {}

    def qkv(layout, B, hq, hkv, S, D, dtype):
        if layout == "model":
            q = tensor(rng, (B, S, hq, D), dtype, dev).transpose(1, 2)
        else:
            q = tensor(rng, (B, hq, S, D), dtype, dev)
        return (q, *_kv(rng, layout, B, hkv, S, D, dtype, dev))

    for layout, hq, hkv in (("tpu", 8, 8), ("model", 24, 8)):
        for B, S, D in ((SLOTS, PROMPT, 128), (1, 40, 128), (2, 200, 64)):
            for causal in (True, False):
                for dtype in ("float32", "bfloat16"):
                    q, k, v = qkv(layout, B, hq, hkv, S, D, dtype)
                    out = flash_attention_fwd(q, k, v, causal=causal)
                    assert out.stride() == q.stride() or not out.is_cuda
                    errs[f"{layout}-{B}x{S}x{D}-causal{int(causal)}-"
                         f"{dtype}"] = held(
                        out, flash_attention_ref(q, k, v, causal=causal),
                        dtype)
    q, k, v = qkv("model", SLOTS, 24, 8, PROMPT, 128, "bfloat16")
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    pairs = SLOTS * 24 * PROMPT * (PROMPT + 1) // 2   # causal (i, j <= i)
    t = timed(lambda: flash_attention_fwd(q, k, v, causal=True),
              lambda: flash_attention_ref(q, k, v, causal=True),
              lambda: F.scaled_dot_product_attention(
                  q, k, v, is_causal=True, enable_gqa=True),
              "flash_attention_kernel",
              (n_bytes, 4 * pairs * 128, BF16_OPS_PER_S))
    t["max_abs_err"] = held(flash_attention_fwd(q, k, v, causal=True),
                            flash_attention_ref(q, k, v, causal=True),
                            "bfloat16")
    return {"errors": errs, "main": t,
            "shape": [SLOTS, 24, 8, PROMPT, 128, "causal"]}


def serve_phase(dev, counters) -> dict:
    """llama3.2-3b at full width through ServeEngine.serve: the serving main
    path with every launch count at 0 just before it, then the same weights
    through the plain path (kernels=False) for comparison."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import zoo
    from repro_torch.models.module import init_from_specs, param_bytes
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = ARCHS[ARCH]
    specs = zoo.build_param_specs(cfg)
    t0 = time.perf_counter()
    params = init_from_specs(specs, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(5).integers(1, cfg.vocab,
                                                size=(N_REQ, PROMPT))

    def requests():
        return [Request(prompt=p, max_new_tokens=NEW) for p in prompts]

    kw = dict(batch_slots=SLOTS, prompt_len=PROMPT, max_len=MAX_LEN,
              device=dev)
    engine = ServeEngine(cfg, params, **kw)
    plain = ServeEngine(cfg, params, kernels=False, **kw)
    assert engine.kernels and not plain.kernels
    plain.run(requests()[:SLOTS])              # warm-up (cuBLAS, allocator)

    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = engine.serve(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    expected = {"serialize_prefix": 0,
                "rmsnorm": (2 * cfg.n_layers + 1) * (WAVES + DECODE_STEPS),
                "decode_attention": cfg.n_layers * DECODE_STEPS,
                "flash_attention": cfg.n_layers * WAVES}
    assert launches == expected, (launches, expected)
    for r in reqs:
        assert r.done and len(r.out_tokens) == NEW, r
        assert all(0 <= t < cfg.vocab for t in r.out_tokens)

    plain_reqs = plain.serve(requests())
    same = [a == b for r, p in zip(reqs, plain_reqs)
            for a, b in zip(r.out_tokens, p.out_tokens)]

    # the first wave's prefill logits, kernel path against plain path
    batch = {"tokens": torch.as_tensor(prompts[:SLOTS], device=dev)}
    logits = {}
    for name, use in (("kernels", None), ("plain", False)):
        caches = init_from_specs(zoo.build_cache_specs(cfg, SLOTS, MAX_LEN),
                                 0, device=dev)
        logits[name], _ = zoo.prefill(cfg, params, batch, caches,
                                      kernels=use)
    diff = float((logits["kernels"] - logits["plain"]).abs().max())
    assert diff <= LOGITS_TOL, diff
    top2 = logits["plain"].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * LOGITS_TOL
    first_k = logits["kernels"].argmax(-1)
    first_p = logits["plain"].argmax(-1)
    assert torch.equal(first_k[clear], first_p[clear])
    assert first_p.tolist() == [r.out_tokens[0] for r in plain_reqs[:SLOTS]]

    def timed_wave(eng):
        """Prefill ms and decode ms per step of one wave, with the engine's
        own host sync (one token read-back per step)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = eng.prefill_step(requests()[:SLOTS])
        tok.tolist()
        t1 = time.perf_counter()
        for _ in range(NEW - 1):
            tok = eng.decode_once(tok)
            tok.tolist()
        t2 = time.perf_counter()
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3 / (NEW - 1), tok

    waves = {name: timed_wave(eng)[:2] for name, eng in
             (("kernels", engine), ("plain", plain), ("kernels_again", engine),
              ("plain_again", plain))}

    # one decode step under the profiler: device busy and idle share
    tok = engine.decode_once(engine.prefill_step(requests()[:SLOTS]))
    device_times(lambda: engine.decode_once(tok).tolist())   # warm-up
    step_ms, rows = device_times(lambda: engine.decode_once(tok).tolist())
    kernels = [r for r in rows if not r[1].startswith("aten::")]
    busy_ms = sum(r[0] for r in kernels) / 1e3
    n_bytes = param_bytes(specs)
    return {
        "phase": "serve", "arch": ARCH, "params": cfg.param_count(),
        "param_bytes": n_bytes, "init_s": init_s, "requests": N_REQ,
        "batch_slots": SLOTS, "prompt_len": PROMPT, "max_len": MAX_LEN,
        "new_tokens": NEW, "waves": WAVES, "decode_steps": DECODE_STEPS,
        "wall_s": wall, "tokens_per_s": N_REQ * NEW / wall,
        "launches": launches,
        "prefill_ms": {k: v[0] for k, v in waves.items()},
        "decode_ms_per_step": {k: v[1] for k, v in waves.items()},
        "weights_bound_ms_per_step": n_bytes / HBM_BYTES_PER_S * 1e3,
        "max_memory_allocated": peak,
        "token_agreement_with_plain": sum(same) / len(same),
        "prefill_logits_max_abs_diff": diff, "logits_tol": LOGITS_TOL,
        "first_tokens_compared": int(clear.sum()),
        "decode_step_profile": {
            "wall_ms": step_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / step_ms,
            "kernel_launches": sum(r[2] for r in kernels),
            "top": [{"name": k[:90], "device_ms": us / 1e3, "count": c}
                    for us, k, c in kernels[:10]]}}


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
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import serialize_prefix_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd
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

    serving = {"rmsnorm": check_rmsnorm(dev),
               "decode_attention": check_decode_attention(dev),
               "flash_attention": check_flash_attention(dev)}
    for name, res in serving.items():
        emit({"phase": "kernel", "name": name, "tolerance": SERVE_TOL,
              "cases": len(res["errors"]),
              "max_abs_err": max(res["errors"].values()),
              "errors": res["errors"], "shape": res["shape"],
              "times": res.get("times", res["main"])})

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
    for fn in (serialize_prefix, rmsnorm_fwd, decode_attention_fwd,
               flash_attention_fwd):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = explore(w, acc, prefilter=True, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = serialize_prefix.launches
    assert res.ga.prefilter_screened > 0, res.ga
    assert launches > 0, "explore never launched the serialize kernel"
    assert rmsnorm_fwd.launches == decode_attention_fwd.launches == \
        flash_attention_fwd.launches == 0
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

    # ---- the serving main path: llama3.2-3b through ServeEngine.serve ----
    counters = {"serialize_prefix": serialize_prefix,
                "rmsnorm": rmsnorm_fwd,
                "decode_attention": decode_attention_fwd,
                "flash_attention": flash_attention_fwd}
    served = serve_phase(dev, counters)
    emit(served)

    t = times[TIMED_SHAPES[0]]
    rows = [{
        "name": "serialize_prefix", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wavefront.cu",
        "replaces": "src/repro/kernels/wavefront.py:37",
        "paths": ["fitness", "explore"], "launches": launches,
        "max_abs_err": max_abs,
        "ms": t["ms"], "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1], "library_ms": None,
        "shape": list(TIMED_SHAPES[0])}]
    for name, replaces in (
            ("rmsnorm", "src/repro/kernels/rmsnorm.py:20"),
            ("decode_attention", "src/repro/kernels/decode_attention.py:56"),
            ("flash_attention", "src/repro/kernels/flash_attention.py:69")):
        m = serving[name]["main"]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "paths": ["serve"],
            "launches": served["launches"][name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "device_ms": m["device_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shape": serving[name]["shape"]})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
