"""Each CUDA kernel of the PyTorch/CUDA port alone on one NVIDIA GPU.

    PYTHONPATH=src python3 chip_smoke.py

Phases, one JSON line each; the first failure raises, so the script exits
non-zero and prints no `ok` line:

1. device  — the card (`nvidia-smi`), torch and CUDA versions;
2. build   — every kernel under src/repro_torch/kernels/csrc, one nvcc per
             source, all started together, with ptxas' registers and spills;
3. host    — one rmsnorm wrapper call's host time split into its parts;
4. kernel  — each kernel against its plain PyTorch version on the card
             (serialize_prefix, rmsnorm, decode_attention, flash_attention,
             ssd_scan, rwkv6_scan, moe_gemm), with its times at the main
             paths' shapes, its bound and the time (events and device) of
             one PyTorch call computing the same function; the bf16
             serving shapes of moe_gemm and flash attention must run their
             tensor-core kernels, decode attention its split kernel, and
             the attention kernels' bf16 errors are also given in bf16
             ulps of the plain version in float32 (at most 2); flash
             attention also at causal S != T (the top-left mask) and at
             whisper's non-causal shapes (T 1500, D 64), moe_gemm also at
             deepseek-v2's 160 experts; the two scans at every shape of
             their grids through the kernel `variant` chooses, rwkv6 with
             logw at and far below the clip; mla_attention (MLA's prefill,
             qk 128 + 64 and v 128, no `pallas_call` behind it) at a
             card's layer of dsv2-tp4-prefill, beside the model's plain
             path;
5. fitness — wavefront_scan alone at the prefilter chunk of a cell (256
             genomes of resnet18 on MC:Hetero and of squeezenet on
             MC:HomTPU x4, tile 32) against its plain version, with its
             times and bound.

Then a line `{"kernels": [...]}` (each kernel's row of PERF.md's kernel
table), the `nvidia-smi` name and power limit, and last `{"ok": true,
"device": {...}}`.  Exits non-zero without CUDA.

The port's end-to-end numbers come from its benchmark (`python3
chipbench/run.py`), and `tests/test_torch_cuda.py` holds the paths around
the kernels on the card.
"""
from __future__ import annotations

import json
import os
import re
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

# The serving shapes the kernels are timed at: 4 slots, prompts of 128
# tokens, caches of 168 positions; a decode step of llama3.2-3b in the
# middle of its waves' 32 new tokens, and of zamba2-2.7b's 16.
SLOTS, PROMPT, MAX_LEN = 4, 128, 168
SERVE_CUR = PROMPT + 32 // 2
ZAMBA2_CUR = PROMPT + 16 // 2
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


def kernel_label(mangled: str) -> str:
    """`name<template arguments>` of a mangled kernel name: the last of its
    length-prefixed (nested) names, and its template arguments (bf16 or f32,
    then the integers)."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    targs = re.match(r"I(.*?)Ev", mangled[i:])
    if not targs:
        return name
    t = targs.group(1)
    args = ["bf16"] if "bfloat16" in t else ["f32"] if t[:1] == "f" else []
    return f"{name}<{','.join(args + re.findall(r'Li(\d+)E', t))}>"


def ptxas_summary(text: str) -> list[dict]:
    """Registers and spill bytes of each kernel that `nvcc -Xptxas -v`
    compiled, from what it printed."""
    rows, spill = [], (0, 0)
    fn = None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            rows.append({"kernel": kernel_label(fn),
                         "registers": int(m.group(1)),
                         "spill_stores": spill[0], "spill_loads": spill[1]})
            fn, spill = None, (0, 0)
    return rows


def cuda_ms(*fns, iters: int = 200, warmup: int = 20,
            windows: int = 1) -> float | list[float]:
    """Mean ms per call of each of `fns` over `iters` back-to-back calls, by
    CUDA events on the current stream. With several `windows` of `iters`
    calls, the median window of each, the functions' windows taken in turn
    (a, b, a, b, ...), so that one stall of the shared host neither stands
    for a call's cost nor falls on one function only. One function gives a
    float, several a list."""
    import torch
    for fn in fns:
        for _ in range(warmup):
            fn()
    means = [[] for _ in fns]
    for _ in range(windows):
        for fn, m in zip(fns, means):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            m.append(start.elapsed_time(end) / iters)
    out = [float(np.median(m)) for m in means]
    return out[0] if len(fns) == 1 else out


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
        if getattr(ev, "is_user_annotation", False):
            continue            # a program span's range, not device work
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    return wall * 1e3, rows


def kernel_device_ms(fn, name: str, iters: int = 100,
                     tries: int = 3) -> float | None:
    """Mean device ms of the kernels whose name holds `name`, over `iters`
    calls of `fn` (None when the profiler sees no such kernel in `tries`
    profiles: on the H100 it has once returned a profile without the
    cluster-launched kernel whose launches the wrapper counted)."""
    for _ in range(tries):
        _, rows = device_times(lambda: [fn() for _ in range(iters)])
        hits = [(us, c) for us, k, c in rows if name in k]
        if hits:
            return sum(us for us, _ in hits) / 1e3 / sum(c for _, c in hits)
    return None


def call_device_ms(fn, iters: int = 100) -> float:
    """Device ms of one call of `fn`: the profiler's sum over every kernel
    it launches (a library call may launch several), over `iters` calls."""
    _, rows = device_times(lambda: [fn() for _ in range(iters)])
    return sum(us for us, k, _ in rows if not k.startswith("aten::")) / 1e3 \
        / iters


def scan_work(packed: dict, outs, shape) -> tuple[float, float]:
    """(bytes, float32 operations) of one `wavefront_scan` launch: every
    input the kernel reads (the packed genome-major tensors and the static
    tables) once and every output once; per genome and wavefront about 6
    operations per slot and queue (cores and channels), 2 per predecessor
    slot, 4 per slot for its ready time and 10 per core for the spill
    model."""
    P, L, W, D, C, H = shape
    n_bytes = sum(t.numel() * t.element_size() for t in packed.values()) \
        + sum(t.numel() * t.element_size() for t in outs)
    n_ops = P * L * (6 * W * (C + H) + 2 * W * D + 4 * W + 10 * C)
    return n_bytes, n_ops


def fitness_phase(dev, session, w, acc) -> dict:
    """`wavefront_scan` alone at one cell's prefilter chunk (256 genomes)
    against its plain version on the card: its error, events and device
    times and its bound."""
    import torch
    from repro_torch.core.allocator import feasible_cores_per_layer
    from repro_torch.core.vectorized import BatchedFitness
    from repro_torch.kernels.ref import (population_last,
                                         serialize_prefix_ref,
                                         wavefront_scan_ref)
    from repro_torch.kernels.wavefront import pack, wavefront_scan
    engine = session.engine(w, acc, GRAN)
    feas = feasible_cores_per_layer(w, acc)
    grng = np.random.default_rng(1)
    pop = np.stack([[f[grng.integers(len(f))] for f in feas]
                    for _ in range(256)])
    kern = BatchedFitness(engine, device=dev)
    assert kern.route == "fused", kern.route
    chunk = kern.chunk_size(len(pop))
    g = torch.as_tensor(pop[:chunk], device=dev)
    xs, st, kw = kern.scan_args(g)

    def fused():
        return wavefront_scan(g, xs, st, **kw)

    def ref():
        return wavefront_scan_ref(
            g, xs, st, serialize=population_last(serialize_prefix_ref), **kw)

    outs, want_outs = fused(), ref()
    torch.cuda.synchronize()
    max_abs = 0.0
    bit_equal = True
    for got_t, want_t in zip(outs, want_outs):
        torch.testing.assert_close(got_t, want_t, rtol=RTOL, atol=0.0)
        max_abs = max(max_abs, float((got_t - want_t).abs().max()))
        bit_equal = bit_equal and torch.equal(got_t, want_t)
    shape = (chunk, kern.n_wavefronts, kern.width, kern.dmax, kern.n_cores,
             kern.n_chan)
    b = bound(*scan_work(pack(g, xs, st), outs, shape), F32_OPS_PER_S)
    return {"phase": "fitness", "workload": w.name, "arch": acc.name,
            "genomes": len(pop), "chunk": chunk, "cns": engine.graph.n,
            "shape": dict(zip(("P", "L", "W", "D", "C", "H"), shape)),
            "max_abs_err": max_abs, "bit_equal_plain": bit_equal,
            "ms": cuda_ms(fused, iters=50, windows=5),
            "device_ms": kernel_device_ms(fused, "wavefront_scan_kernel",
                                          iters=20),
            "plain_ms": cuda_ms(ref, iters=3, warmup=1),
            "bound_ms": b[0], "bound_by": b[1]}


# ---- the serving kernels ---------------------------------------------------

def tensor(rng, shape, dtype, dev):
    """Standard normals from a numpy generator, as a tensor on `dev`."""
    import torch
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.as_tensor(a, device=dev).to(getattr(torch, dtype))


def held_tol(got, want, tol: float) -> float:
    """Max abs error of `got` against `want`; raises beyond rtol = atol =
    `tol`."""
    import torch
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    return float((got.float() - want.float()).abs().max())


def held(got, want, dtype) -> float:
    """Max abs error of a kernel's output against its plain version; raises
    beyond the reference's kernel tolerance."""
    return held_tol(got, want, SERVE_TOL[dtype])


def bf16_ulps(got, want) -> float:
    """The largest |got - want| in bf16 spacings at `want`, the plain
    version in float32 on the same bf16 inputs. The spacing is taken at
    |want| >= 2**-8: below that the float32 sums' own error, about 1e-6
    from terms near 1, is no longer small against it."""
    import torch
    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -8)))
                     - 7)
    return float(((got.float() - want).abs() / ulp).max())


def as_float(*tensors):
    return [t.float() for t in tensors]


def bound(n_bytes: float, n_ops: float, ops_per_s: float,
          bf16_ops: float = 0.0):
    """The least time for the work, ms: bytes over the memory rate or
    operations over the peak rate for their type (`n_ops` at `ops_per_s`
    plus `bf16_ops` products at the bf16 tensor rate), whichever is
    larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / ops_per_s + bf16_ops / BF16_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(kern, plain, library, name: str, work, plain_iters: int = 200,
          iters: int = 200) -> dict:
    """Events ms of the kernel's wrapper and of the library call (median of
    5 windows each, taken in turn), the profiler's device ms of the kernel
    and of the library call (the sum over the kernels it launches), the
    plain version's events ms, and the bound of the work. The library's
    numbers are None where no single PyTorch call computes the function."""
    b = bound(*work)
    if library is None:
        ms, library_ms = cuda_ms(kern, iters=iters, windows=5), None
    else:
        ms, library_ms = cuda_ms(kern, library, iters=iters, windows=5)
    return {"ms": ms, "device_ms": kernel_device_ms(kern, name),
            "plain_ms": cuda_ms(plain, iters=plain_iters,
                                warmup=max(plain_iters // 10, 1)),
            "library_ms": library_ms,
            "library_device_ms": None if library is None
            else call_device_ms(library),
            "bound_ms": b[0], "bound_by": b[1]}


def host_breakdown(dev, n: int = 10000) -> dict:
    """Host us of one rmsnorm wrapper call at a decode step's (4, 3072) in
    bf16, split into its parts, each part alone over `n` calls timed with
    perf_counter_ns, the median of 3 rounds (an empty call's cost included
    in each). The `pr13`
    parts are what the launch path before this one did instead: a set of
    torch.devices, a torch.cuda.device context around the launch, a
    torch.cuda.Stream built per call, and a ctypes call of the same C
    launcher in the same library with its eleven argtypes."""
    import ctypes

    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rm
    rng = np.random.default_rng(9)
    x = tensor(rng, (SLOTS, 3072), "bfloat16", dev)
    s = tensor(rng, (3072,), "bfloat16", dev)
    out = torch.empty_like(x)
    lib = build.load_library("rmsnorm")
    index = build.cuda_index(x, s)
    args = (x.data_ptr(), s.data_ptr(), out.data_ptr(), SLOTS, 3072, 1e-5, 1,
            1, 1, index, build.stream_of(index))
    no_launch = (*args[:3], 0, *args[4:])      # rows 0: refused, no launch
    c_launcher = ctypes.CDLL(str(build.library_path("rmsnorm"))).repro_rmsnorm
    c_launcher.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    c_launcher.restype = ctypes.c_int

    def device_context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "empty call": lambda: None,
        "shape checks": lambda: s.dim() != 1 or x.dim() == 0 or
        s.shape[0] != x.shape[-1],
        "cuda_index": lambda: build.cuda_index(x, s),
        "dtype_code x2": lambda: (build.dtype_code("x", x),
                                  build.dtype_code("scale", s)),
        "is_contiguous x2": lambda: x.is_contiguous() and s.is_contiguous(),
        "torch.empty_like": lambda: torch.empty_like(x),
        "variant": lambda: rm.variant(x, s),
        "stream_of": lambda: build.stream_of(index),
        "data_ptr x3": lambda: (x.data_ptr(), s.data_ptr(), out.data_ptr()),
        "load_library": lambda: build.load_library("rmsnorm"),
        "module launch": lambda: lib.launch(*args),
        "module call, no launch (rows 0)": lambda: lib.launch(*no_launch),
        "check": lambda: build.check(lib, 0, "rmsnorm"),
        "pr13 one_device": lambda: len({t.device for t in (x, s)}),
        "pr13 device.type checks": lambda: x.device.type in ("cpu", "cuda"),
        "pr13 torch.cuda.device context": device_context,
        "pr13 stream_of (torch.cuda.Stream)":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "pr13 ctypes launch": lambda: c_launcher(*args),
        "pr13 ctypes call, no launch (rows 0)":
            lambda: c_launcher(*no_launch),
        "whole wrapper": lambda: rm.rmsnorm_fwd(x, s),
    }
    us = {}
    for name, fn in parts.items():
        for _ in range(200):
            fn()
        rounds = []
        for _ in range(3):       # the median of 3 rounds of n calls
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(n):
                fn()
            rounds.append((time.perf_counter_ns() - t0) / n / 1e3)
        torch.cuda.synchronize()
        us[name] = float(np.median(rounds))
    return {"phase": "host", "wrapper": "rmsnorm_fwd", "shape": [SLOTS, 3072],
            "dtype": "bfloat16", "calls": n, "rounds": 3, "us_per_call": us}


def check_rmsnorm(dev) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import rmsnorm_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd, variant
    rng = np.random.default_rng(2)
    errs = {}
    for shape in [(SLOTS, 1, 3072), (SLOTS, PROMPT, 3072), (4, 37, 96),
                  (1, 300, 64), (SLOTS, 2560), (SLOTS, PROMPT, 5120),
                  (3, 100), (SLOTS, PROMPT, 8192), (SLOTS, 1, 512),
                  (SLOTS, PROMPT, 512)]:
        for dtype in ("float32", "bfloat16"):
            for sdtype in sorted({dtype, "float32"}):
                x = tensor(rng, shape, dtype, dev)
                s = tensor(rng, shape[-1:], sdtype, dev)
                errs[f"{shape}-{dtype}-{sdtype}"] = held(
                    rmsnorm_fwd(x, s), rmsnorm_ref(x, s), dtype)
    # a row off the 16-byte grid takes the scalar path
    x = tensor(rng, (SLOTS * 3072 + 1,), "bfloat16", dev)[1:].view(SLOTS,
                                                                   3072)
    s = tensor(rng, (3072,), "bfloat16", dev)
    assert variant(x, s) == "scalar"
    errs["misaligned-bfloat16"] = held(rmsnorm_fwd(x, s), rmsnorm_ref(x, s),
                                       "bfloat16")
    times = {}
    for rows in (SLOTS, SLOTS * PROMPT):     # a decode step, a prefill
        x = tensor(rng, (rows, 3072), "bfloat16", dev)
        s = tensor(rng, (3072,), "bfloat16", dev)
        assert variant(x, s) == "vector"
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


def _kv(rng, layout, B, Hkv, T, D, dtype, dev, offset=0):
    """k, v as (B, Hkv, T, D): contiguous (the TPU kernel's layout, G = 1)
    or transposed views of the model's (B, T, Hkv, D) cache, that one
    `offset` elements into its storage."""
    if layout == "model":
        return [tensor(rng, (B * T * Hkv * D + offset,), dtype, dev)[offset:]
                .view(B, T, Hkv, D).transpose(1, 2) for _ in range(2)]
    return [tensor(rng, (B, Hkv, T, D), dtype, dev) for _ in range(2)]


def check_decode_attention(dev) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_fwd,
                                                      variant)
    from repro_torch.kernels.ref import decode_attention_ref
    rng = np.random.default_rng(3)
    errs, ulps = {}, {}
    # the last layout and shape are whisper-large-v3's self attention
    for layout, hq, hkv in (("tpu", 8, 8), ("model", 24, 8),
                            ("model", 64, 8), ("model", 20, 20)):
        for B, T, D in ((SLOTS, MAX_LEN, 128), (2, 200, 64), (3, 64, 128),
                        (SLOTS, MAX_LEN, 80), (SLOTS, MAX_LEN, 64)):
            for cur in (0, 1, 100, T, T + 5):
                for dtype in ("float32", "bfloat16"):
                    q = tensor(rng, (B, hq, D), dtype, dev)
                    k, v = _kv(rng, layout, B, hkv, T, D, dtype, dev)
                    key = (f"{layout}-G{hq // hkv}-{B}x{T}x{D}-cur{cur}-"
                           f"{dtype}-{variant(q, k, v)}")
                    got = decode_attention_fwd(q, k, v, cur)
                    errs[key] = held(got, decode_attention_ref(q, k, v, cur),
                                     dtype)
                    if dtype == "bfloat16":
                        ulps[key] = bf16_ulps(got, decode_attention_ref(
                            *as_float(q, k, v), cur))
    # a cache off the 16-byte grid takes the one-block-a-head kernel
    for dtype in ("float32", "bfloat16"):
        q = tensor(rng, (SLOTS, 24, 128), dtype, dev)
        k, v = _kv(rng, "model", SLOTS, 8, MAX_LEN, 128, dtype, dev, offset=1)
        assert variant(q, k, v) == "head"
        errs[f"misaligned-{dtype}-head"] = held(
            decode_attention_fwd(q, k, v, SERVE_CUR),
            decode_attention_ref(q, k, v, SERVE_CUR), dtype)
    split = {k: u for k, u in ulps.items() if k.endswith("split")}
    assert split and max(split.values()) <= 2.0, split
    # whisper's self attention in bf16 ran the split kernel
    whisper = [k for k in ulps if k.startswith(f"model-G1-{SLOTS}x{MAX_LEN}x64")]
    assert whisper and all(k in split for k in whisper), whisper
    q = tensor(rng, (SLOTS, 24, 128), "bfloat16", dev)
    k, v = _kv(rng, "model", SLOTS, 8, MAX_LEN, 128, "bfloat16", dev)
    assert variant(q, k, v) == "split"
    mask = torch.arange(MAX_LEN, device=dev) < SERVE_CUR
    n_bytes = 2 * q.numel() * 2 + 2 * SLOTS * 8 * SERVE_CUR * 128 * 2
    t = timed(lambda: decode_attention_fwd(q, k, v, SERVE_CUR),
              lambda: decode_attention_ref(q, k, v, SERVE_CUR),
              lambda: F.scaled_dot_product_attention(
                  q[:, :, None], k, v, attn_mask=mask[None],
                  enable_gqa=True),
              "decode_attention_kernel_split",
              (n_bytes, 4 * SLOTS * 24 * SERVE_CUR * 128, BF16_OPS_PER_S))
    assert t["device_ms"] is not None, "the split kernel never ran"
    got = decode_attention_fwd(q, k, v, SERVE_CUR)
    t["max_abs_err"] = held(got, decode_attention_ref(q, k, v, SERVE_CUR),
                            "bfloat16")
    t["max_ulps"] = bf16_ulps(got, decode_attention_ref(*as_float(q, k, v),
                                                        SERVE_CUR))
    t["variant"] = "split"
    # the same launch over one key: what the kernel costs without its work
    t["device_ms_cur1"] = kernel_device_ms(
        lambda: decode_attention_fwd(q, k, v, 1),
        "decode_attention_kernel_split")
    # zamba2-2.7b's shared block: 32 heads over 32 KV heads, D = 80, the
    # middle of a wave's decode steps
    cur = ZAMBA2_CUR
    q80 = tensor(rng, (SLOTS, 32, 80), "bfloat16", dev)
    k80, v80 = _kv(rng, "model", SLOTS, 32, MAX_LEN, 80, "bfloat16", dev)
    assert variant(q80, k80, v80) == "split"
    mask = torch.arange(MAX_LEN, device=dev) < cur
    d80 = timed(lambda: decode_attention_fwd(q80, k80, v80, cur),
                lambda: decode_attention_ref(q80, k80, v80, cur),
                lambda: F.scaled_dot_product_attention(
                    q80[:, :, None], k80, v80, attn_mask=mask[None]),
                "decode_attention_kernel_split",
                (2 * q80.numel() * 2 + 2 * SLOTS * 32 * cur * 80 * 2,
                 4 * SLOTS * 32 * cur * 80, BF16_OPS_PER_S))
    got = decode_attention_fwd(q80, k80, v80, cur)
    d80["max_abs_err"] = held(got, decode_attention_ref(q80, k80, v80, cur),
                              "bfloat16")
    d80["max_ulps"] = bf16_ulps(got, decode_attention_ref(
        *as_float(q80, k80, v80), cur))
    d80["variant"] = "split"
    d80["shape"] = [SLOTS, 32, 32, MAX_LEN, 80, cur]
    return {"errors": errs, "ulps": ulps, "main": t, "d80": d80,
            "shape": [SLOTS, 24, 8, MAX_LEN, 128, SERVE_CUR]}


def check_flash_attention(dev) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     variant)
    from repro_torch.kernels.ref import (flash_attention_ref,
                                         flash_attention_top_left_ref)
    rng = np.random.default_rng(4)
    errs, ulps = {}, {}

    def qkv(layout, B, hq, hkv, S, D, dtype, offset=0):
        if layout == "model":
            q = tensor(rng, (B, S * hq * D + offset), dtype, dev)[:, offset:]
            q = q.view(B, S, hq, D).transpose(1, 2)
        else:
            q = tensor(rng, (B, hq, S, D), dtype, dev)
        return (q, *_kv(rng, layout, B, hkv, S, D, dtype, dev))

    # the last layout and shape are whisper-large-v3's self attention at
    # prefill (causal, S = T = PROMPT, 20 heads of D 64)
    for layout, hq, hkv in (("tpu", 8, 8), ("model", 24, 8),
                            ("model", 16, 2), ("model", 20, 20)):
        for B, S, D in ((SLOTS, PROMPT, 128), (1, 40, 128), (2, 200, 64),
                        (SLOTS, PROMPT, 80), (1, 1, 128), (2, 65, 80),
                        (1, 200, 128), (SLOTS, PROMPT, 64)):
            for causal in (True, False):
                for dtype in ("float32", "bfloat16"):
                    q, k, v = qkv(layout, B, hq, hkv, S, D, dtype)
                    out = flash_attention_fwd(q, k, v, causal=causal)
                    assert out.stride() == q.stride() or not out.is_cuda
                    key = (f"{layout}-G{hq // hkv}-{B}x{S}x{D}-"
                           f"causal{int(causal)}-{dtype}-{variant(q, k, v)}")
                    errs[key] = held(
                        out, flash_attention_ref(q, k, v, causal=causal),
                        dtype)
                    if dtype == "bfloat16":
                        ulps[key] = bf16_ulps(out, flash_attention_ref(
                            *as_float(q, k, v), causal=causal))
    # causal S != T: the top-left mask (query i sees keys j <= i), both
    # kernels, against the top-left plain version
    for S, T, D in ((PROMPT, MAX_LEN, 128), (MAX_LEN, PROMPT, 128),
                    (40, 200, 80), (65, 1, 128)):
        for dtype in ("float32", "bfloat16"):
            q = tensor(rng, (2, 24, S, D), dtype, dev)
            k, v = (tensor(rng, (2, 8, T, D), dtype, dev) for _ in range(2))
            errs[f"s_not_t-{S}x{T}x{D}-{dtype}-{variant(q, k, v)}"] = held(
                flash_attention_fwd(q, k, v, causal=True),
                flash_attention_top_left_ref(q, k, v), dtype)
    # queries off the 16-byte grid take the CUDA-core kernel
    q, k, v = qkv("model", SLOTS, 24, 8, PROMPT, 128, "bfloat16", offset=1)
    assert variant(q, k, v) == "fma"
    errs["misaligned-bfloat16-fma"] = held(
        flash_attention_fwd(q, k, v), flash_attention_ref(q, k, v),
        "bfloat16")
    mma = {k: u for k, u in ulps.items() if k.endswith("mma")}
    assert mma and max(mma.values()) <= 2.0, mma
    # whisper's causal self attention in bf16 ran the tensor-core kernel
    assert f"model-G1-{SLOTS}x{PROMPT}x64-causal1-bfloat16-mma" in mma
    q, k, v = qkv("model", SLOTS, 24, 8, PROMPT, 128, "bfloat16")
    assert variant(q, k, v) == "mma"
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    pairs = SLOTS * 24 * PROMPT * (PROMPT + 1) // 2   # causal (i, j <= i)
    t = timed(lambda: flash_attention_fwd(q, k, v, causal=True),
              lambda: flash_attention_ref(q, k, v, causal=True),
              lambda: F.scaled_dot_product_attention(
                  q, k, v, is_causal=True, enable_gqa=True),
              "flash_attention_kernel_mma",
              (n_bytes, 4 * pairs * 128, BF16_OPS_PER_S))
    assert t["device_ms"] is not None, "the tensor-core kernel never ran"
    got = flash_attention_fwd(q, k, v, causal=True)
    t["max_abs_err"] = held(got, flash_attention_ref(q, k, v, causal=True),
                            "bfloat16")
    t["max_ulps"] = bf16_ulps(got, flash_attention_ref(*as_float(q, k, v),
                                                       causal=True))
    t["variant"] = "mma"
    # twice the products (no causal skip): how far the work sets the time
    t["device_ms_noncausal"] = kernel_device_ms(
        lambda: flash_attention_fwd(q, k, v, causal=False),
        "flash_attention_kernel_mma")
    # zamba2-2.7b's shared block at prefill: 32 heads, D = 80
    q, k, v = qkv("model", SLOTS, 32, 32, PROMPT, 80, "bfloat16")
    assert variant(q, k, v) == "mma"
    pairs = SLOTS * 32 * PROMPT * (PROMPT + 1) // 2
    d80 = timed(lambda: flash_attention_fwd(q, k, v, causal=True),
                lambda: flash_attention_ref(q, k, v, causal=True),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
                "flash_attention_kernel_mma",
                (2 * (2 * q.numel() + k.numel() + v.numel()),
                 4 * pairs * 80, BF16_OPS_PER_S))
    got = flash_attention_fwd(q, k, v, causal=True)
    d80["max_abs_err"] = held(got, flash_attention_ref(q, k, v, causal=True),
                              "bfloat16")
    d80["max_ulps"] = bf16_ulps(got, flash_attention_ref(*as_float(q, k, v),
                                                         causal=True))
    d80["variant"] = "mma"
    d80["shape"] = [SLOTS, 32, 32, PROMPT, 80, "causal"]
    # whisper-large-v3: 20 heads of D 64, non-causal over its 1500 frames,
    # in the model's transposed views: the encoder (S = T = 1500), a
    # prefill's cross attention (S = PROMPT) and a decode step's (S = 1)
    whisper = {}
    for S in (1500, PROMPT, 1):
        q = tensor(rng, (SLOTS, S, 20, 64), "bfloat16", dev).transpose(1, 2)
        k, v = _kv(rng, "model", SLOTS, 20, 1500, 64, "bfloat16", dev)
        assert variant(q, k, v) == "mma"
        w = timed(lambda: flash_attention_fwd(q, k, v, causal=False),
                  lambda: flash_attention_ref(q, k, v, causal=False),
                  lambda: F.scaled_dot_product_attention(q, k, v),
                  "flash_attention_kernel_mma",
                  (2 * (2 * q.numel() + k.numel() + v.numel()),
                   4 * SLOTS * 20 * S * 1500 * 64, BF16_OPS_PER_S),
                  plain_iters=20, iters=50)
        got = flash_attention_fwd(q, k, v, causal=False)
        w["max_abs_err"] = held(got, flash_attention_ref(q, k, v,
                                                         causal=False),
                                "bfloat16")
        w["max_ulps"] = bf16_ulps(got, flash_attention_ref(
            *as_float(q, k, v), causal=False))
        w["shape"] = [SLOTS, 20, 20, S, 1500, 64, "non-causal"]
        whisper[f"S{S}"] = w
    return {"errors": errs, "ulps": ulps, "main": t, "d80": d80,
            "whisper": whisper,
            "shape": [SLOTS, 24, 8, PROMPT, 128, "causal"]}


def check_mla_attention(dev) -> dict:
    """MLA's prefill attention kernel against the model's plain path
    (`cat`-built per-head keys, `blocked_attention`) at the YaRN scale,
    and timed beside it at a card's layer of dsv2-tp4-prefill: B 8 x S
    4096, 32 heads, qk 128 + 64, v 128."""
    import math

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.mla_attention import mla_attention_fwd, variant
    from repro_torch.kernels.ref import mla_attention_ref
    from repro_torch.models.attention import mla_temperature
    from repro_torch.models.layers import blocked_attention
    scale = mla_temperature({"type": "yarn", "factor": 40,
                             "mscale_all_dim": 0.707}) / math.sqrt(192)
    gen = torch.Generator(device=dev).manual_seed(9)

    def inputs(B, S, H):
        return tuple(torch.randn(shape, generator=gen, device=dev).bfloat16()
                     for shape in ((B, S, H, 192), (B, S, H, 128),
                                   (B, S, 64), (B, S, H, 128)))

    def keys(kn, kr):
        B, T, H, _ = kn.shape
        return torch.cat([kn, kr[:, :, None].expand(B, T, H, 64)], -1)

    errs = {}
    for B, S, H in ((2, 1, 32), (2, 65, 32), (2, 1000, 32), (1, 2048, 32)):
        q, kn, kr, v = inputs(B, S, H)
        assert variant(q, kn, kr, v) == "mma"
        got = mla_attention_fwd(q, kn, kr, v, scale=scale)
        errs[f"{B}x{S}x{H}-plain-path"] = held(
            got, blocked_attention(q, keys(kn, kr), v, scale=scale),
            "bfloat16")
        if S <= 1000:
            errs[f"{B}x{S}x{H}-twin"] = held(
                got, mla_attention_ref(q, kn, kr, v, scale=scale), "bfloat16")
    B, S, H = 8, 4096, 32
    q, kn, kr, v = inputs(B, S, H)
    kf = keys(kn, kr)
    flops = 2 * B * H * S * (S + 1) // 2 * (192 + 128)
    n_bytes = 2 * (q.numel() + kn.numel() + kr.numel() + 2 * v.numel())
    sdpa = (q.transpose(1, 2), kf.transpose(1, 2), v.transpose(1, 2))

    def library():
        return F.scaled_dot_product_attention(*sdpa, is_causal=True,
                                              scale=scale)

    try:                    # a backend that takes qk 192 != v 128, if any
        library()
    except RuntimeError:
        library = None
    t = timed(lambda: mla_attention_fwd(q, kn, kr, v, scale=scale),
              lambda: blocked_attention(q, keys(kn, kr), v, scale=scale),
              library, "mla_attention_kernel_mma",
              (n_bytes, flops, BF16_OPS_PER_S), plain_iters=5, iters=20)
    assert t["device_ms"] is not None, "the kernel never ran"
    got = mla_attention_fwd(q, kn, kr, v, scale=scale)
    t["max_abs_err"] = held(got, blocked_attention(q, kf, v, scale=scale),
                            "bfloat16")
    t["variant"] = "mma"
    t["tflops"] = flops / (t["device_ms"] * 1e-3) / 1e12
    return {"errors": errs, "main": t,
            "shape": [B, S, H, 192, 128, "causal", "yarn scale"]}


def ssd_inputs(rng, B, S, H, P, N, dtype, dev, init):
    import torch
    x = tensor(rng, (B, S, H, P), dtype, dev)
    dt = torch.nn.functional.softplus(tensor(rng, (B, S, H), "float32", dev))
    A = -torch.exp(0.5 * tensor(rng, (H,), "float32", dev))
    Bm = tensor(rng, (B, S, N), dtype, dev)
    Cm = tensor(rng, (B, S, N), dtype, dev)
    s0 = tensor(rng, (B, H, P, N), "float32", dev) if init else None
    return x, dt, A, Bm, Cm, s0


def split_products(itemsize: int, float32_operands: int) -> int:
    """bf16 tensor-core products that hold one float32-precision product:
    each float32 operand, and each operand of a float32 call, is split into
    bf16 hi and lo parts, and the lo lo product is dropped (the kernels
    show that this holds SCAN_TOL and STATE_TOL). One split operand takes
    2 products, two take 3."""
    return 2 if float32_operands == 1 and itemsize == 2 else 3


def ssd_work(B, S, H, P, N, L, itemsize):
    """(bytes, float32 operations, rate, bf16 tensor operations) of one
    ssd_scan launch: x, y, B, C in the working type, dt, A and the state in
    and out in float32. B and C are shared across heads, so the function
    needs the causal C.B tile once per (b, chunk), exact on bf16 tensor
    cores in bf16. Per (b, h, chunk) the intra-chunk term of y, y from the
    state and the state update each multiply a float32 operand (the decayed
    scores, the state, x dt decayed) by one of the working type, so they
    count at the tensor rate times `split_products`; the decays, the
    cumsum, x dt and the state's decay count at the float32 rate."""
    n_bytes = (2 * B * S * H * P + 2 * B * S * N) * itemsize + \
        4 * (B * S * H + H + 2 * B * H * P * N)
    chunks = B * H * (S // L)
    scores = B * (S // L) * (L * (L + 1) // 2) * 2 * N * \
        (1 if itemsize == 2 else 3)
    products = P * L * (L + 1) + L * P * 2 * N + P * N * 2 * L
    elementwise = 3 * (L * (L + 1) // 2) + 3 * L + 2 * L * P + P * N
    return (n_bytes, chunks * elementwise, F32_OPS_PER_S,
            scores + chunks * products * split_products(itemsize, 1))



def check_ssd_scan(dev) -> dict:
    from repro_torch.kernels.ref import SCAN_TOL, STATE_TOL, ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan, variant
    rng = np.random.default_rng(6)
    errs = {}
    # L, P and N off the tensor cores' 16 and P off the slab of 32 included
    for B, S, H, P, N, L in ((1, 32, 1, 8, 4, 8), (2, 64, 3, 16, 8, 16),
                             (1, 128, 2, 32, 16, 32), (1, 48, 2, 8, 8, 8),
                             (2, 72, 3, 48, 24, 24), (1, 80, 2, 80, 40, 40),
                             (SLOTS, PROMPT, 80, 64, 64, 64)):
        for dtype in ("float32", "bfloat16"):
            for init in (False, True):
                x, dt, A, Bm, Cm, s0 = ssd_inputs(rng, B, S, H, P, N, dtype,
                                                  dev, init)
                route = variant(x, Bm, Cm, L)
                # N = 4 in bf16 is 8 bytes a row: the old kernel's
                assert route == ("old" if N * x.element_size() < 16
                                 else "tiled"), (B, S, H, P, N, dtype)
                want_y, want_s = ssd_scan_ref(x, dt, A, Bm, Cm, s0)
                y, s = ssd_scan(x, dt, A, Bm, Cm, chunk=L, initial_state=s0)
                key = (f"{B}x{S}x{H}x{P}x{N}-L{L}-{dtype}-"
                       f"init{int(init)}-{route}")
                errs[key] = held_tol(y, want_y, SCAN_TOL[dtype])
                errs[key + "-state"] = held_tol(s, want_s, STATE_TOL)
    # zamba2-2.7b's prefill: the cache's state goes in at every layer
    x, dt, A, Bm, Cm, s0 = ssd_inputs(rng, SLOTS, PROMPT, 80, 64, 64,
                                      "bfloat16", dev, True)
    assert variant(x, Bm, Cm) == "tiled"
    t = timed(lambda: ssd_scan(x, dt, A, Bm, Cm, initial_state=s0),
              lambda: ssd_scan_ref(x, dt, A, Bm, Cm, s0), None,
              "ssd_scan_kernel_tiled",
              ssd_work(SLOTS, PROMPT, 80, 64, 64, 64, 2), plain_iters=10)
    assert t["device_ms"] is not None, "the tiled kernel never ran"
    t["variant"] = "tiled"
    t["max_abs_err"] = held_tol(ssd_scan(x, dt, A, Bm, Cm,
                                         initial_state=s0)[0],
                                ssd_scan_ref(x, dt, A, Bm, Cm, s0)[0],
                                SCAN_TOL["bfloat16"])
    return {"errors": errs, "main": t, "tolerance": SCAN_TOL,
            "state_tolerance": STATE_TOL,
            "shape": [SLOTS, PROMPT, 80, 64, 64, 64]}


def rwkv_inputs(rng, B, S, H, K, V, dtype, dev, init, logw_case="some"):
    """r, k, v, logw, u and the initial state; logw random with every 7th
    position below the clip ("some"), all at the clip ("at_clip") or all
    far below it ("below"): in both last cases every cum reaches -6 L."""
    import torch
    r = tensor(rng, (B, S, H, K), dtype, dev)
    k = tensor(rng, (B, S, H, K), dtype, dev)
    v = tensor(rng, (B, S, H, V), dtype, dev)
    logw = -torch.nn.functional.softplus(
        tensor(rng, (B, S, H, K), "float32", dev)) - 0.5
    if logw_case == "some":
        logw[:, ::7] -= 20.0                # below the clip at -6
    else:
        logw.fill_(-6.0 if logw_case == "at_clip" else -40.0)
    u = 0.1 * tensor(rng, (H, K), "float32", dev)
    s0 = tensor(rng, (B, H, K, V), "float32", dev) if init else None
    return r, k, v, logw, u, s0


def rwkv_work(B, S, H, K, V, L, itemsize, sub: int = 8):
    """(bytes, float32 operations, rate, bf16 tensor operations) of one
    rwkv6_scan launch: r, k, v, o in the working type, logw, u and the
    state in and out in float32. Per (b, h, chunk) the products, at the
    tensor rate times `split_products`: the causal score tile from the
    decayed r and k factors (both float32), o from the scores (float32)
    and v, o from r e^cum_ex and the state (both float32), and the state
    update from the decayed k (float32) and v. At the float32 rate: the
    cumsum, the exponentials the factored score tile needs (L K (L/sub +
    1) for the factors, L (sub - 1) K / 2 on the diagonal sub-blocks), the
    decayed r and k, the bonus and the state's decay."""
    n_bytes = (3 * B * S * H * K + B * S * H * V) * itemsize + \
        4 * (B * S * H * K + H * K + 2 * B * H * K * V)
    chunks = B * H * (S // L)
    pairs = L * (L - 1) // 2
    products = 2 * pairs * K * split_products(itemsize, 2) + \
        2 * pairs * V * split_products(itemsize, 1) + \
        2 * L * K * V * split_products(itemsize, 2) + \
        2 * K * V * L * split_products(itemsize, 1)
    exps = L * K * (L // sub + 1) + L * (sub - 1) * K // 2
    elementwise = L * K + exps + 4 * L * K + 3 * L * K + 2 * L * V + K * V
    return (n_bytes, chunks * elementwise, F32_OPS_PER_S,
            chunks * products)


def check_rwkv6_scan(dev) -> dict:
    import torch
    from repro_torch.kernels.ref import SCAN_TOL, STATE_TOL, rwkv6_scan_ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, variant
    rng = np.random.default_rng(7)
    errs = {}
    # L off the tensor cores' 16, K off 16 and V off the slab of 32 included
    for B, S, H, K, V, L in ((1, 32, 1, 8, 8, 8), (2, 64, 3, 16, 16, 16),
                             (1, 96, 2, 32, 16, 32), (2, 72, 3, 64, 48, 24),
                             (1, 64, 2, 40, 80, 16),
                             (SLOTS, PROMPT, 40, 64, 64, 32)):
        for dtype in ("float32", "bfloat16"):
            for init in (False, True):
                for case in ("some", "at_clip", "below"):
                    r, k, v, logw, u, s0 = rwkv_inputs(
                        rng, B, S, H, K, V, dtype, dev, init, case)
                    assert variant(r, k, v, logw, L) == "tiled"
                    want_o, want_s = rwkv6_scan_ref(r, k, v, logw, u, s0)
                    o, s = rwkv6_scan(r, k, v, logw, u, chunk=L,
                                      initial_state=s0)
                    assert bool(torch.isfinite(o).all()) and \
                        bool(torch.isfinite(s).all())
                    key = (f"{B}x{S}x{H}x{K}x{V}-L{L}-{dtype}-"
                           f"init{int(init)}-logw_{case}-tiled")
                    errs[key] = held_tol(o, want_o, SCAN_TOL[dtype])
                    errs[key + "-state"] = held_tol(s, want_s, STATE_TOL)
    # rwkv6-3b's prefill: the cache's state goes in at every layer
    r, k, v, logw, u, s0 = rwkv_inputs(rng, SLOTS, PROMPT, 40, 64, 64,
                                       "bfloat16", dev, True)
    assert variant(r, k, v, logw) == "tiled"
    t = timed(lambda: rwkv6_scan(r, k, v, logw, u, initial_state=s0),
              lambda: rwkv6_scan_ref(r, k, v, logw, u, s0), None,
              "rwkv6_scan_kernel_tiled",
              rwkv_work(SLOTS, PROMPT, 40, 64, 64, 32, 2), plain_iters=10)
    assert t["device_ms"] is not None, "the tiled kernel never ran"
    t["variant"] = "tiled"
    t["max_abs_err"] = held_tol(rwkv6_scan(r, k, v, logw, u,
                                           initial_state=s0)[0],
                                rwkv6_scan_ref(r, k, v, logw, u, s0)[0],
                                SCAN_TOL["bfloat16"])
    return {"errors": errs, "main": t, "tolerance": SCAN_TOL,
            "state_tolerance": STATE_TOL,
            "shape": [SLOTS, PROMPT, 40, 64, 64, 32]}


def check_moe_gemm(dev) -> dict:
    import torch
    from repro_torch.kernels.moe_gemm import moe_gemm, variant
    from repro_torch.kernels.ref import MOE_TOL, moe_gemm_ref
    gen = torch.Generator(device=dev).manual_seed(8)

    def randn(shape, dtype, scale):   # on the card: the weights are large
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            getattr(torch, dtype))

    errs = {}
    for E, C, K, N in ((2, 32, 64, 48), (4, 64, 96, 80), (1, 128, 128, 128),
                       (64, 8, 2048, 1408), (64, 8, 1408, 2048),
                       (64, 60, 2048, 1408), (64, 60, 1408, 2048),
                       (3, 17, 33, 65), (2, 1, 64, 48), (2, 9, 64, 48),
                       (2, 65, 64, 48)):
        for dtype in ("float32", "bfloat16"):
            x, w = randn((E, C, K), dtype, 0.3), randn((E, K, N), dtype, 0.3)
            errs[f"{E}x{C}x{K}x{N}-{dtype}-{variant(x, w)}"] = held_tol(
                moe_gemm(x, w), moe_gemm_ref(x, w), MOE_TOL[dtype])
    # bf16 off the 16-byte grid runs the CUDA-core kernel
    x = randn((2 * 16 * 64 + 1,), "bfloat16", 0.3)[1:].view(2, 16, 64)
    w = randn((2, 64, 48), "bfloat16", 0.3)
    assert variant(x, w) == "fma"
    errs["misaligned-bfloat16-fma"] = held_tol(
        moe_gemm(x, w), moe_gemm_ref(x, w), MOE_TOL["bfloat16"])
    times = {}
    # deepseek-moe-16b's decode step and prefill, gate/up and down products
    for C, K, N in ((8, 2048, 1408), (60, 2048, 1408), (8, 1408, 2048),
                    (60, 1408, 2048)):
        x = randn((64, C, K), "bfloat16", 1.0)
        w = randn((64, K, N), "bfloat16", 0.02)
        assert variant(x, w) == "mma"
        t = timed(lambda: moe_gemm(x, w), lambda: moe_gemm_ref(x, w),
                  lambda: torch.bmm(x, w), "moe_gemm_kernel_mma",
                  ((x.numel() + w.numel() + 64 * C * N) * 2,
                   2 * 64 * C * K * N, BF16_OPS_PER_S),
                  plain_iters=20, iters=50)
        assert t["device_ms"] is not None, "the tensor-core kernel never ran"
        t["variant"] = "mma"
        t["max_abs_err"] = held_tol(moe_gemm(x, w), moe_gemm_ref(x, w),
                                    MOE_TOL["bfloat16"])
        times[f"{C}x{K}x{N}"] = t
    # deepseek-v2-236b: 160 experts, d_model 5120, d_ff_expert 1536; C 8 at
    # a decode step of 4 slots, C 24 at a prefill of 4 x 128 tokens
    for K, N in ((5120, 1536), (1536, 5120)):
        w = randn((160, K, N), "bfloat16", 0.02)
        for C in (8, 24):
            x = randn((160, C, K), "bfloat16", 1.0)
            assert variant(x, w) == "mma"
            t = timed(lambda: moe_gemm(x, w), lambda: moe_gemm_ref(x, w),
                      lambda: torch.bmm(x, w), "moe_gemm_kernel_mma",
                      ((x.numel() + w.numel() + 160 * C * N) * 2,
                       2 * 160 * C * K * N, BF16_OPS_PER_S),
                      plain_iters=5, iters=20)
            assert t["device_ms"] is not None
            t["variant"] = "mma"
            t["max_abs_err"] = held_tol(moe_gemm(x, w), moe_gemm_ref(x, w),
                                        MOE_TOL["bfloat16"])
            times[f"E160-{C}x{K}x{N}"] = t
        del w
    return {"errors": errs, "main": times["8x2048x1408"], "times": times,
            "tolerance": MOE_TOL, "shape": [64, 8, 2048, 1408]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.api.session import default_session
    from repro_torch.configs.paper_workloads import resnet18, squeezenet
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
          "ptxas": {k: ptxas_summary(v)
                    for k, v in sorted(build.ptxas_info.items())},
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
            "ms": cuda_ms(lambda: serialize_prefix(free0, release, dur),
                          windows=5),
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

    emit(host_breakdown(dev))
    serving = {"rmsnorm": check_rmsnorm(dev),
               "decode_attention": check_decode_attention(dev),
               "flash_attention": check_flash_attention(dev),
               "ssd_scan": check_ssd_scan(dev),
               "rwkv6_scan": check_rwkv6_scan(dev),
               "moe_gemm": check_moe_gemm(dev),
               "mla_attention": check_mla_attention(dev)}
    for name, res in serving.items():
        line = {"phase": "kernel", "name": name,
                "tolerance": res.get("tolerance", SERVE_TOL),
                "cases": len(res["errors"]),
                "max_abs_err": max(res["errors"].values()),
                "errors": res["errors"], "shape": res["shape"],
                "times": res.get("times", res["main"])}
        for extra in ("d80", "ulps", "whisper"):
            if extra in res:
                line[extra] = res[extra]
        if "state_tolerance" in res:
            line["state_tolerance"] = res["state_tolerance"]
        emit(line)

    # ---- wavefront_scan at the prefilter's chunks -------------------------
    session = default_session()
    fitness = [fitness_phase(dev, session, w, acc)
               for w, acc in ((resnet18(), mc_hetero()),
                              (squeezenet(), mc_hom_tpu_chip4()))]
    for line in fitness:
        emit(line)

    t = times[TIMED_SHAPES[0]]
    sc = fitness[0]
    rows = [{
        "name": "wavefront_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wavefront.cu",
        "replaces": "src/repro/kernels/wavefront.py:37",
        "max_abs_err": max(f["max_abs_err"] for f in fitness),
        "ms": sc["ms"], "device_ms": sc["device_ms"],
        "plain_ms": sc["plain_ms"], "bound_ms": sc["bound_ms"],
        "bound_by": sc["bound_by"], "library_ms": None,
        "library_device_ms": None, "shape": sc["shape"],
        "by_cell": {f"{f['workload']} x {f['arch']}":
                    {k: f[k] for k in ("device_ms", "ms", "bound_ms")}
                    for f in fitness}}, {
        "name": "serialize_prefix", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wavefront.cu",
        "replaces": "src/repro/kernels/wavefront.py:37",
        "max_abs_err": max_abs,
        "ms": t["ms"], "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1], "library_ms": None,
        "library_device_ms": None,
        "shape": list(TIMED_SHAPES[0])}]
    for name, replaces in (
            ("rmsnorm", "src/repro/kernels/rmsnorm.py:20"),
            ("decode_attention", "src/repro/kernels/decode_attention.py:56"),
            ("flash_attention", "src/repro/kernels/flash_attention.py:69"),
            ("ssd_scan", "src/repro/kernels/ssd_scan.py:60"),
            ("rwkv6_scan", "src/repro/kernels/rwkv6_scan.py:58"),
            ("moe_gemm", "src/repro/kernels/moe_gemm.py:39"),
            ("mla_attention", "port-only (no pallas_call)")):
        m = serving[name]["main"]
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "device_ms": m["device_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "library_device_ms": m["library_device_ms"],
            "shape": serving[name]["shape"]}
        for extra in ("variant", "max_ulps", "tflops"):
            if extra in m:
                row[extra] = m[extra]
        rows.append(row)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
