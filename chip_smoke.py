"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    PYTHONPATH=src python3 chip_smoke.py

Phases, one JSON line each; the first failure raises, so the script exits
non-zero and prints no `ok` line:

1. device  — the card (`nvidia-smi`), torch and CUDA versions;
2. build   — every kernel under src/repro_torch/kernels/csrc, one nvcc per
             source, all started together, with ptxas' registers and spills;
3. host    — one rmsnorm wrapper call's host time split into its parts;
   kernel  — each kernel against its plain PyTorch version on the card
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
             deepseek-v2's 160 experts; the two
             scans at every shape of their grids through each of their
             kernels (the tiled one and the old one), rwkv6 with
             logw at and far below the clip, and at the serving shapes the
             tiled kernel's times beside the old kernel's;
4. fitness — BatchedFitness on the card, per cell both kernel routes in
             turns (fused: one wavefront_scan launch a chunk; step: a
             serialize_prefix launch a queue update), each against the
             plain path and the CPU, with launch counts, genomes/s and a
             profile; then wavefront_scan alone at the cell's chunk against
             its plain version, timed beside the step route's scan;
5. explore — Stream's explore(prefilter=True) on the card, the DSE main
             path, with every launch count set to 0 just before it: one
             wavefront_scan launch a prefilter chunk, no other kernel, and
             each chunk scored again through the plain loop, bit-equal;
   validate — the final schedule again with validate=True (the port's
             race detector), and the detector's report;
   sweep   — the DSE runtime (`repro_torch.api`): the paper's Figs. 13-15
             grid (5 workloads x 7 architectures x layer and tile 32, pop
             10, 6 generations, 70 points) through a prefiltered, traced,
             serial `ExplorationSession.run` into a store on disk, every
             launch count set to 0 just before it: one wavefront_scan
             launch a prefilter chunk, no other kernel, every record equal
             to the exact engine's schedule of its allocation; each chunk
             the sweep gave wavefront_scan scored again through the plain
             PyTorch loop (bit-equal), and the whole grid again with the
             prefilter on that loop (every record and tracer counter
             equal); the paper's
             per-architecture geomean EDP gain; a fresh session over the
             same store (70 store hits, 0 scheduled, 0 launches); the
             28-point space of examples/distributed_sweep.py through the
             spawn-based process executor from this process, which holds
             a CUDA context, plain and under a seeded schedule of worker
             kills and straggler deadlines, and through 2 shards
             (`run_shard`, `merge_stores`), each equal to the serial
             unfiltered run; a Chrome trace of the best fused record's
             schedule, checked, and its bottleneck report;
   tools   — the port's sweep CLIs in process (`repro_torch.tools`):
             the 28-point manifest through `run_shard` as shards 0/2 and
             1/2 with heartbeats, `merge_stores` (and `--verify`; a corrupt
             copy exits 4, a missing source 2), `sweep_top --once` over the
             heartbeats, `trace_export` twice, byte-identical; the merged
             records equal the distributed phase's serial run key for key
             and byte for byte; 0 launches (the CLIs run unfiltered);
   simulate — `repro_torch.launch.serve --simulate` for the transformer,
             rwkv and ssm serving families, twice each, equal both times;
6. serve   — llama3.2-3b, zamba2-2.7b, rwkv6-3b, deepseek-moe-16b,
             qwen2-vl-72b (16 of 80 layers) and deepseek-v2-236b (4 of 60),
             one after another, each at full width (seeded random weights
             on the card) through ServeEngine.serve, a serving main path
             each, with every launch count set to 0 just before it; then
             the kernel path against the plain path (kernels=False) on the
             same weights, one prefill wave and one decode step under the
             profiler (device busy ms, each port kernel's share; the scans'
             prefill runs their tiled kernels), and the model freed before
             the next; for the three of them with scans or expert GEMMs,
             the two paths again on float32 weights at full width and
             depth, for qwen2-vl-72b and deepseek-v2-236b at depth 2;
   whisper — whisper-large-v3 at full width and depth (before qwen2-vl):
             zoo.prefill over seeded frame embeddings and 16 greedy
             zoo.decode_step calls, with every launch count set to 0 just
             before them, the plain path on the same inputs, the uncached
             encode + decode_stack forward both ways (the pass in which
             cross attention reads the encoder output), a profiled
             prefill and decode step, and the float32 gate at full depth
             over the cached and the uncached passes;
7. train   — llama3.2-3b training at full width and depth (bf16, remat,
             seeded random weights, TokenStream's synthetic data) through
             `repro_torch.launch.train.main` (8 steps, B 8 x S 1024), with
             every launch count set to 0 just before it: the training path
             runs the plain layers, so every count must still be 0 after
             it; then 6 steps timed by CUDA events (step ms, tokens/s, MFU
             against 989 TFLOP/s, peak memory), one profiled step (device
             busy ms, idle share, launches, the largest kernels and aten
             ops), 8 steps on one repeated batch at a constant 3e-5 (the
             loss must fall by LEARN_DROP), one step with int8 gradient
             compression (ef finite);
   train_float32 — the same model at 2 layers in float32, TF32 off: one
             step on the card against the CPU, microbatches 2 against 1
             and remat against none on the card, and a blocking and an
             async checkpoint round trip where zstandard imports;
   dryrun  — the dry run (`repro_torch.launch.dryrun`: one run on fake
             tensors of rank 0's program over an abstract mesh, counted by
             `analysis.hlo`'s recorder, the H100 roofline of
             `analysis.roofline`), with every launch count set to 0 just
             before it and 0 after: at the train shape (llama3.2-3b, B 8 x
             S 1024, full remat, a (1, 1) mesh) its FLOPs against
             FlopCounterMode over the same step on the card and its
             argument bytes against the memory those tensors take there
             (each within DRY_TOL), its argument plus temp bytes against
             the card's peak, its roofline step time and MFU against the
             card's step; its memory term of one plain decode step (4
             slots) against the card's; then the production meshes: every
             config at decode_32k and train_4k on (16, 16) and
             llama3.2-3b's train_4k on (2, 16, 16), each OK or SKIP, none
             FAIL, cut to DRY_DEPTH layers and without prefill_32k so the
             phase stays within DRY_BUDGET_S;
8. mesh    — the multi-device layer on a one-rank NCCL process group (a
             file:// store, no network) under `make_host_mesh()`, (1, 1) on
             cuda: llama3.2-3b through `ServeEngine(mesh=)` with the
             mesh-free engine's tokens and launches; `decode_step(
             kv_seq_shard=True)` at full width and depth against the plain
             decode in float32 (F32_LOGITS_TOL); one deepseek-moe-16b MoE
             layer at full width through `moe_ffn(mesh=)`, bit-equal to the
             mesh-free call, 3 `moe_gemm` launches of the `_mma` variant;
             the GPipe pipeline at one stage (B 8 x S 1024, 4 microbatches,
             remat) against `zoo.train_loss` (bf16 loss 1e-3; float32 at 2
             layers, gradients 1e-4); `make_production_mesh()` refused at a
             world of 1; then two ranks sharing the card through gloo (its
             transport is host memory): a probe of the collectives on CUDA
             tensors, split-KV decode on the (2, 1) mesh and a 2-stage
             pipeline (14 layers a stage), each held in float32 at 2
             layers against this rank's results and timed in bf16 at full
             width and depth, and the MoE layer on a (1, 2) mesh, each
             rank's half of d_ff (704) through `moe_gemm`'s `_mma`
             kernel, held against this rank's output in bf16; then the
             tensor-parallel dense layers on the (1, 2) mesh: llama3.2-3b
             served at full width and depth through `ServeEngine(mesh=)`
             with the kernels on each rank's 12 of 24 heads (launches
             equal to `zoo.kernel_launches`' counts, flash attention
             `_mma`, decode attention `_split` on the cache's KV-head
             view; both ranks' tokens equal), its float32 gate at 2
             layers against this rank's logits (F32_LOGITS_TOL), float32
             gradients at 2 layers against the mesh-free step on the same
             rank (loss 1e-5, gradients 1e-4), and a bf16 train step at
             full width and depth, timed.  The line names each part's
             backend and world size.

Then a line `{"kernels": [...]}`, the `nvidia-smi` name and power limit, and
last `{"ok": true, "device": {...}}`.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
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

# The serving main paths: each model at full width under
# ServeEngine(batch_slots=4, prompt_len=128, max_len=168), 8 requests, so
# two FIFO waves of one prefill and NEW - 1 decode steps each.
SLOTS, PROMPT, MAX_LEN, N_REQ = 4, 128, 168, 8
WAVES = N_REQ // SLOTS
# model -> (new tokens per request, bf16 prefill logits limit of the kernel
# path against the plain path). The kernels round in other places than the
# plain layers (p in float32, one rounding of the norm, float32 scans and
# expert sums, each output rounded once to bf16), and through a deep stack
# of random weights those one-ulp differences compound. Each limit is about
# twice the difference measured on an H100 (see PERF.md): llama3.2-3b
# 0.0506, zamba2-2.7b 0.113, rwkv6-3b 0.567, deepseek-moe-16b 0.0374,
# qwen2-vl-72b 0.0763 (16 layers), deepseek-v2-236b 0.0167 (4 layers), with
# logits up to 4.4-8.3 in magnitude. For llama3.2-3b this bf16 comparison
# is the gate, and at least one first token must be clear of a near tie.
# For the models of F32_CHECK it is a report: at such limits, and
# with top-1 margins of a few tenths, it could pass a wrong kernel (rwkv6-3b
# compares no first token). Their gate is the float32 check below, with
# each kernel held alone at its serving shape in bf16 in the kernel phase.
SERVED = {"llama3.2-3b": (32, 0.1), "zamba2-2.7b": (16, 0.25),
          "rwkv6-3b": (16, 1.2), "deepseek-moe-16b": (16, 0.1),
          "qwen2-vl-72b": (16, 0.15), "deepseek-v2-236b": (16, 0.035)}
# Depth of the models whose full depth does not fit one card: qwen2-vl-72b
# (72.7 B parameters, 145 GB in bf16) runs 16 of its 80 layers at full
# width (16.5 B, 33.1 GB), deepseek-v2-236b (240.6 B, 481 GB) 4 of its 60
# (its dense first layer and 3 MoE layers of 160 routed experts and 2
# shared: 13.6 B, 27.2 GB). Every other model runs at full depth.
DEPTH = {"qwen2-vl-72b": 16, "deepseek-v2-236b": 4}
# The gate of the scan and expert paths: the same comparison at full width
# and depth in float32, where no bf16 rounding feeds the divergence. The
# kernel path sums float32 in another order than the plain path: 6.1e-6
# (deepseek-moe-16b) to 1.2e-4 (rwkv6-3b) measured on an H100, with logits
# up to 4.8, so the limit is 1e-3.
# model -> depth of its float32 check (None: full depth). qwen2-vl-72b and
# deepseek-v2-236b run 2 layers there (8.5 and 11.0 GB of bf16 weights,
# twice that in float32); whisper-large-v3 has its own check at full depth
# (whisper_phase).
F32_CHECK = {"zamba2-2.7b": None, "rwkv6-3b": None, "deepseek-moe-16b": None,
             "qwen2-vl-72b": 2, "deepseek-v2-236b": 2}
F32_LOGITS_TOL = 1e-3
# whisper-large-v3 at full width and depth: zoo.prefill of 4 prompts of
# PROMPT tokens over seeded frame embeddings (4, 1500, 1280), then
# WHISPER_NEW greedy zoo.decode_step calls, as the reference's own smoke test
# drives the entry points
WHISPER = "whisper-large-v3"
WHISPER_NEW = 16
# whisper-large-v3's bf16 limits, kernel path against plain path, each about
# twice the difference measured on an H100 (see PERF.md): the prefill's
# logits 0.0199, the first decode step's 0.0196, the uncached forward's
# 0.0394, with logits up to 2.9 in magnitude. Its gate is the float32 check
# at full depth (whisper_phase).
WHISPER_TOL = {"prefill": 0.04, "decode": 0.04, "uncached": 0.08}
# The sweep phase: benchmarks/bench_exploration.py's quick grid (the paper's
# Figs. 13-15: 5 workloads x 7 architectures x layer-by-layer and 32-band
# layer fusion, GA pop 10, 6 generations, seed 0), and the 28-point space of
# examples/distributed_sweep.py (squeezenet and fsrcnn, pop 8, 5 generations)
# for the process executor and the shards.
SWEEP_GA = dict(pop_size=10, generations=6, seed=0)
SWEEP_POINTS = 70
DIST_GA = dict(pop_size=8, generations=5)
DIST_WORKLOADS = ("squeezenet", "fsrcnn")
FAMILIES = ("transformer", "rwkv", "ssm")
# the middle of a wave's decode steps of llama3.2-3b, which attend over
# 129..159 positions
SERVE_CUR = PROMPT + SERVED["llama3.2-3b"][0] // 2
# The training main path: `python -m repro_torch.launch.train` at the full
# width and depth of llama3.2-3b (bf16, remat, seeded random weights,
# TokenStream's synthetic data), then the same model for TRAIN_TIMED more
# steps timed by CUDA events (the first is a warm-up) and one profiled step.
TRAIN_ARCH = "llama3.2-3b"
TRAIN_B, TRAIN_S = 8, 1024
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--steps", "8", "--batch", str(TRAIN_B),
              "--seq", str(TRAIN_S), "--device", "cuda"]
TRAIN_TIMED = 6
# The learning gate: LEARN_STEPS steps on one repeated batch at full width,
# continuing the timed steps' parameters and optimizer state at a constant
# learning rate LEARN_LR (no warmup, no decay); the last loss must lie
# LEARN_DROP nats below the first. At launch.train's 1.5e-4 to 3e-4 the
# loss on one batch overshoots and climbs for two steps before it falls;
# at 3e-5 it fell by 0.91 nats in 8 steps on an H100 80GB HBM3 at 700 W,
# so the margin is about half that (PERF.md, "Training").
LEARN_STEPS = 8
LEARN_LR = 3e-5
LEARN_DROP = 0.5
# The float32 gate: llama3.2-3b at full width, 2 layers, float32, TF32 off:
# one train step on the card against the same step on the CPU (1e-4 of each
# tensor's largest magnitude), microbatches 2 against 1 (1e-5) and remat
# against none (1e-6) on the card; the parameters beyond what their held
# moments explain (`train_rel_diff`).
TRAIN_F32 = {"depth": 2, "batch": 1, "seq": 128, "cpu_tol": 1e-4,
             "microbatch_tol": 1e-5, "remat_tol": 1e-6}
# The mesh phase: llama3.2-3b through the multi-device layer on a one-rank
# process group, deepseek-moe-16b's MoE layer at full width through
# `moe_ffn(mesh=)`, and the GPipe pipeline at PIPE's shape (B 8 x S 1024, 4
# microbatches, remat): one stage here, two stages of 14 layers on two
# ranks sharing the card where gloo lets them.
MESH_ARCH, MESH_MOE = "llama3.2-3b", "deepseek-moe-16b"
PIPE = {"batch": 8, "seq": 1024, "microbatches": 4}
# Tensor-parallel dense layers on two "model" ranks sharing the card, a
# (1, 2) (data, model) mesh: MESH_ARCH served at full width and depth
# through `ServeEngine(mesh=)` with the kernels on each rank's heads (12 of
# 24, 4 of 8 KV heads), d_ff and vocabulary; its float32 gate at
# `gate_layers` against the one-rank logits (F32_LOGITS_TOL); a float32
# train step's loss (TP_TRAIN_TOL relative) and gradients (TP_GRAD_TOL of
# each leaf's largest magnitude) at `gate_layers` against the mesh-free
# step on the same rank, at PIPE's batch and seq; and a bf16 train step at
# full width and depth, timed (TP_TIMED steps after a warm-up).
TP_MESH = (1, 2)
TP_TRAIN_TOL, TP_GRAD_TOL = 1e-5, 1e-4
TP_TIMED = 2
# The mixers tensor-parallel on the same two ranks (ROADMAP item 17b):
# zamba2-2.7b (Mamba2 on 40 of 80 SSD heads a rank, the shared block on 16
# of 32 heads), rwkv6-3b (20 of 40 heads, 4480 of the channel mix's d_ff)
# and deepseek-v2-236b at DEPTH's 4 layers (MLA on 64 of 128 heads, the
# experts' d_ff 768 of 1536) served at full width with the kernels, each
# rank's launches equal to `zoo.kernel_launches(cfg, mesh)` (the split
# norms run their plain math, by design) and each kernel's variant on the
# local heads asserted (TP_ROUTES); a float32 gate at TP_MIXER_DEPTH
# against the one-rank logits (F32_LOGITS_TOL); float32 train gradients of
# TP_MIXER_TRAIN at TP_MIXER_DEPTH and TP_MIXER_SHAPE against the
# mesh-free step (TP_TRAIN_TOL, TP_GRAD_TOL). zamba2-2.7b's depth is one
# group of its hybrid stack (6 Mamba2 layers and the shared block): at 2
# layers it would run no group. deepseek-v2-236b's bf16 weights, 27.2 GB
# whole and 14 GB a rank, are drawn whole and cut rank after rank, so the
# card never holds two whole copies.
TP_MIXERS = ("zamba2-2.7b", "rwkv6-3b", "deepseek-v2-236b")
# new tokens a request of the mixers' TP serving (SERVED's for llama3.2-3b):
# zamba2-2.7b's decode step moves Mamba2's whole `in_proj` over "model"
# through host memory (about 4 s a step on two gloo ranks sharing the
# card), so a short wave keeps the phase inside the smoke's limit
TP_MIXER_NEW = 4
TP_MIXER_DEPTH = {"zamba2-2.7b": 6, "rwkv6-3b": 2, "deepseek-v2-236b": 2}
TP_MIXER_TRAIN = ("zamba2-2.7b", "rwkv6-3b")
TP_MIXER_SHAPE = {"batch": 4, "seq": 512}
# model -> (kernel, variant, pass) each tensor-parallel engine must run
TP_ROUTES = {
    "llama3.2-3b": [("flash_attention_kernel", "_mma", "prefill"),
                    ("decode_attention_kernel", "_split", "decode")],
    "zamba2-2.7b": [("ssd_scan_kernel", "_tiled", "prefill"),
                    ("flash_attention_kernel", "_mma", "prefill"),
                    ("decode_attention_kernel", "_split", "decode")],
    "rwkv6-3b": [("rwkv6_scan_kernel", "_tiled", "prefill")],
    "deepseek-v2-236b": [("moe_gemm_kernel", "_mma", "prefill"),
                         ("moe_gemm_kernel", "_mma", "decode")]}
# The dryrun phase. (a) The dry run held against the card at the train
# phase's shape (TRAIN_ARCH, B 8 x S 1024, full remat, on a (1, 1) mesh) and
# at a serving decode step (4 slots over a cache of MAX_LEN, cur_len
# MAX_LEN - 1): its FLOPs against FlopCounterMode over one step on the card
# and its argument bytes against the memory the same tensors take there,
# each within DRY_TOL (the same program and tensors, counted twice); its
# memory, step time and MFU beside the card's, reported. (b) The production
# meshes: every config at DRY_SHAPES on (16, 16) and TRAIN_ARCH's train_4k
# on (2, 16, 16), each cell OK or SKIP and none FAIL. The phase must stay
# within DRY_BUDGET_S, so (b) is cut: prefill_32k runs in no cell (it
# unrolls 2048 attention block pairs a layer: minutes a cell on the host),
# and each config runs at DRY_DEPTH layers (1 where absent; whisper also 1
# encoder layer): the MoE configs their dense first layer and one MoE
# layer, zamba2-2.7b one group of its hybrid stack. `python -m
# repro_torch.launch.dryrun --both-meshes` runs the full grid.
DRY_TOL = 0.01
DRY_SHAPES = ("train_4k", "decode_32k")
DRY_DEPTH = {"zamba2-2.7b": 6, "deepseek-moe-16b": 2, "deepseek-v2-236b": 2}
DRY_TIMED = 3
DRY_DECODE_STEPS = 20
DRY_BUDGET_S = 120.0
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
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    return wall * 1e3, rows


def step_profile(fn) -> tuple[dict, list]:
    """`fn` under the profiler after one warm-up under it: the line's
    profile (wall ms, device busy ms, idle share, launches, the ten
    largest kernels) and the device kernels' rows (us, name, count)."""
    device_times(fn)
    wall_ms, rows = device_times(fn)
    kernels = [r for r in rows if not r[1].startswith("aten::")]
    busy = sum(r[0] for r in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms,
            "kernel_launches": sum(r[2] for r in kernels),
            "top": [{"name": k[:90], "device_ms": us / 1e3, "count": c}
                    for us, k, c in kernels[:10]]}, kernels


def assert_variant(kernels, kernel: str, suffix: str) -> None:
    """Every profiled launch of `kernel` ran its `suffix` variant, and
    there was at least one."""
    names = [k for _, k, _ in kernels if kernel in k]
    assert names and all(kernel + suffix in k for k in names), names


def kernel_device_ms(fn, name: str, iters: int = 100, tries: int = 3,
                     exclude: str | None = None) -> float | None:
    """Mean device ms of the kernels whose name holds `name` (and not
    `exclude`), over `iters` calls of `fn` (None when the profiler sees no
    such kernel in `tries` profiles: on the H100 it has once returned a
    profile without the cluster-launched kernel whose launches the wrapper
    counted)."""
    for _ in range(tries):
        _, rows = device_times(lambda: [fn() for _ in range(iters)])
        hits = [(us, c) for us, k, c in rows
                if name in k and not (exclude and exclude in k)]
        if hits:
            return sum(us for us, _ in hits) / 1e3 / sum(c for _, c in hits)
    return None


def call_device_ms(fn, iters: int = 100) -> float:
    """Device ms of one call of `fn`: the profiler's sum over every kernel
    it launches (a library call may launch several), over `iters` calls."""
    _, rows = device_times(lambda: [fn() for _ in range(iters)])
    return sum(us for us, k, _ in rows if not k.startswith("aten::")) / 1e3 \
        / iters


def profile_scores(bf, pop) -> dict:
    """Where one scores() call spends its time on the card: wall time, the
    device's busy time (sum of kernel times) and its idle share, launches,
    the two wavefront kernels' device time and launches, and the kernels
    with the most device time."""
    device_times(lambda: bf.scores(pop))        # the profiler's own warm-up
    wall_ms, rows = device_times(lambda: bf.scores(pop))
    kernels = [r for r in rows if not r[1].startswith("aten::")]
    busy_ms = sum(r[0] for r in kernels) / 1e3
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms if kernels else None,
           "kernel_launches": sum(r[2] for r in kernels)}
    for key, name in (("scan", "wavefront_scan_kernel"),
                      ("serialize", "serialize_prefix_kernel")):
        hits = [r for r in kernels if name in r[1]]
        out[f"{key}_device_ms"] = sum(r[0] for r in hits) / 1e3
        out[f"{key}_count"] = sum(r[2] for r in hits)
    out["top"] = [{"name": k[:90], "device_ms": us / 1e3, "count": c}
                  for us, k, c in kernels[:8]]
    return out


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
    """BatchedFitness on the card for one cell (256 genomes): the fused
    route (one `wavefront_scan` launch a chunk) and the step route (a
    `serialize_prefix` launch a queue update) in turns (fused, step, step,
    fused), each held against the plain loop on the card and against the
    CPU, with its launches, genomes/s and profile; then `wavefront_scan`
    alone at the cell's chunk against its plain version, timed beside the
    step route's scan on the same inputs."""
    import torch
    from repro_torch.core.allocator import feasible_cores_per_layer
    from repro_torch.core.vectorized import BatchedFitness, rank_correlation
    from repro_torch.kernels.ref import (population_last,
                                         serialize_prefix_ref,
                                         wavefront_scan_ref)
    from repro_torch.kernels.wavefront import (pack, serialize_prefix,
                                               wavefront_scan)
    engine = session.engine(w, acc, GRAN)
    feas = feasible_cores_per_layer(w, acc)
    grng = np.random.default_rng(1)
    pop = np.stack([[f[grng.integers(len(f))] for f in feas]
                    for _ in range(256)])
    bfs = {"fused": BatchedFitness(engine, device=dev),
           "step": BatchedFitness(engine, device=dev, kernel="step")}
    plain = BatchedFitness(engine, device=dev, use_kernel=False)
    assert bfs["fused"].contention == "serialize", bfs["fused"].contention
    assert (bfs["fused"].route, bfs["step"].route) == ("fused", "step")
    kern = bfs["fused"]
    chunk = kern.chunk_size(len(pop))
    n_chunks = -(-len(pop) // chunk)
    per_chunk = kern.n_wavefronts * (2 if kern.comm else 1)
    want = {"fused": {"wavefront_scan": n_chunks, "serialize_prefix": 0},
            "step": {"wavefront_scan": 0,
                     "serialize_prefix": per_chunk * n_chunks}}
    for bf in (*bfs.values(), plain):
        bf.scores(pop)                                 # warm-up
    rates = {"fused": [], "step": []}
    scores = {}
    for route in ("fused", "step", "step", "fused"):
        wavefront_scan.launches = serialize_prefix.launches = 0
        t0 = time.perf_counter()
        s = bfs[route].scores(pop)
        rates[route].append(len(pop) / (time.perf_counter() - t0))
        got = {"wavefront_scan": wavefront_scan.launches,
               "serialize_prefix": serialize_prefix.launches}
        assert got == want[route], (route, got, want[route])
        assert np.array_equal(scores.setdefault(route, s), s), route
    t0 = time.perf_counter()
    s_p = plain.scores(pop)
    t_p = time.perf_counter() - t0
    s_c = BatchedFitness(engine, device="cpu",
                         contention="serialize").scores(pop[:16])
    for route, s in scores.items():
        np.testing.assert_allclose(s, s_p, rtol=RTOL)
        np.testing.assert_allclose(s[:16], s_c, rtol=RTOL)
        assert np.all(np.isfinite(s)) and np.all(s > 0), route
    t0 = time.perf_counter()
    exact = engine.evaluate_population(pop, "latency")
    t_e = time.perf_counter() - t0

    # the kernel alone at the chunk's shapes, against its plain version and
    # beside the step route's scan on the same inputs
    g = torch.as_tensor(pop[:chunk], device=dev)
    xs, st, kw = kern.scan_args(g)

    def fused():
        return wavefront_scan(g, xs, st, **kw)

    def ref():
        return wavefront_scan_ref(
            g, xs, st, serialize=population_last(serialize_prefix_ref), **kw)

    def step():
        return wavefront_scan_ref(
            g, xs, st, serialize=population_last(serialize_prefix), **kw)

    outs, want_outs, step_outs = fused(), ref(), step()
    torch.cuda.synchronize()
    max_abs = 0.0
    bit_equal = True
    for got_t, want_t, step_t in zip(outs, want_outs, step_outs):
        torch.testing.assert_close(got_t, want_t, rtol=RTOL, atol=0.0)
        torch.testing.assert_close(step_t, want_t, rtol=RTOL, atol=0.0)
        max_abs = max(max_abs, float((got_t - want_t).abs().max()))
        bit_equal = bit_equal and torch.equal(got_t, want_t)
    shape = (chunk, kern.n_wavefronts, kern.width, kern.dmax, kern.n_cores,
             kern.n_chan)
    b = bound(*scan_work(pack(g, xs, st), outs, shape), F32_OPS_PER_S)
    _, step_rows = device_times(step)
    step_kernels = [r for r in step_rows if not r[1].startswith("aten::")]
    scan = {"shape": dict(zip(("P", "L", "W", "D", "C", "H"), shape)),
            "max_abs_err": max_abs, "bit_equal_plain": bit_equal,
            "ms": cuda_ms(fused, iters=50, windows=5),
            "device_ms": kernel_device_ms(fused, "wavefront_scan_kernel",
                                          iters=20),
            "plain_ms": cuda_ms(ref, iters=3, warmup=1),
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
            "old": {"route": "step", "ms": cuda_ms(step, iters=3, warmup=1),
                    "device_ms": sum(r[0] for r in step_kernels) / 1e3,
                    "serialize_device_ms": sum(
                        r[0] for r in step_kernels
                        if "serialize_prefix" in r[1]) / 1e3,
                    "kernel_launches": sum(r[2] for r in step_kernels)}}
    return {"phase": "fitness", "workload": w.name, "arch": acc.name,
            "genomes": len(pop), "chunk": chunk, "cns": engine.graph.n,
            "wavefronts": kern.n_wavefronts, "width": kern.width,
            "dmax": kern.dmax, "cores": kern.n_cores,
            "channels": kern.n_chan, "launches": want,
            "genomes_per_s": rates,
            "plain_genomes_per_s": len(pop) / t_p,
            "exact_genomes_per_s": len(pop) / t_e,
            "max_rel_vs_plain": {r: float(np.max(np.abs(s - s_p)
                                                 / np.abs(s_p)))
                                 for r, s in scores.items()},
            "max_rel_vs_cpu": {r: float(np.max(np.abs(s[:16] - s_c)
                                               / np.abs(s_c)))
                               for r, s in scores.items()},
            "rank_corr_latency": rank_correlation(scores["fused"][:, 0],
                                                  exact[:, 0]),
            "rank_corr_energy": rank_correlation(scores["fused"][:, 1],
                                                 exact[:, 1]),
            "profile": {r: profile_scores(bf, pop) for r, bf in bfs.items()},
            "scan": scan}


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
          iters: int = 200, exclude: str | None = None) -> dict:
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
    return {"ms": ms, "device_ms": kernel_device_ms(kern, name,
                                                    exclude=exclude),
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
    cur = PROMPT + SERVED["zamba2-2.7b"][0] // 2
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


def scan_times(call, plain, name: str, work) -> dict:
    """`timed` of a scan's tiled kernel and of its old kernel, both through
    the launcher, in one run: {"tiled": times, "old": times}."""
    out, tiled = {}, f"{name}_tiled"
    for kernel in ("tiled", "old"):
        out[kernel] = timed(lambda: call(kernel), plain, None,
                            tiled if kernel == "tiled" else name, work,
                            plain_iters=10,
                            exclude=None if kernel == "tiled" else tiled)
        assert out[kernel]["device_ms"] is not None, (name, kernel)
    return out


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
                for kernel in dict.fromkeys((route, "old")):
                    y, s = ssd_scan(x, dt, A, Bm, Cm, chunk=L,
                                    initial_state=s0, kernel=kernel)
                    key = (f"{B}x{S}x{H}x{P}x{N}-L{L}-{dtype}-"
                           f"init{int(init)}-{kernel}")
                    errs[key] = held_tol(y, want_y, SCAN_TOL[dtype])
                    errs[key + "-state"] = held_tol(s, want_s, STATE_TOL)
    # zamba2-2.7b's prefill: the cache's state goes in at every layer
    x, dt, A, Bm, Cm, s0 = ssd_inputs(rng, SLOTS, PROMPT, 80, 64, 64,
                                      "bfloat16", dev, True)
    assert variant(x, Bm, Cm) == "tiled"
    times = scan_times(
        lambda kernel: ssd_scan(x, dt, A, Bm, Cm, initial_state=s0,
                                kernel=kernel),
        lambda: ssd_scan_ref(x, dt, A, Bm, Cm, s0), "ssd_scan_kernel",
        ssd_work(SLOTS, PROMPT, 80, 64, 64, 64, 2))
    t = dict(times["tiled"], variant="tiled")
    t["max_abs_err"] = held_tol(ssd_scan(x, dt, A, Bm, Cm,
                                         initial_state=s0)[0],
                                ssd_scan_ref(x, dt, A, Bm, Cm, s0)[0],
                                SCAN_TOL["bfloat16"])
    t["old"] = times["old"]
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
                    for kernel in ("tiled", "old"):
                        o, s = rwkv6_scan(r, k, v, logw, u, chunk=L,
                                          initial_state=s0, kernel=kernel)
                        assert bool(torch.isfinite(o).all()) and \
                            bool(torch.isfinite(s).all())
                        key = (f"{B}x{S}x{H}x{K}x{V}-L{L}-{dtype}-"
                               f"init{int(init)}-logw_{case}-{kernel}")
                        errs[key] = held_tol(o, want_o, SCAN_TOL[dtype])
                        errs[key + "-state"] = held_tol(s, want_s,
                                                        STATE_TOL)
    # rwkv6-3b's prefill: the cache's state goes in at every layer
    r, k, v, logw, u, s0 = rwkv_inputs(rng, SLOTS, PROMPT, 40, 64, 64,
                                       "bfloat16", dev, True)
    assert variant(r, k, v, logw) == "tiled"
    times = scan_times(
        lambda kernel: rwkv6_scan(r, k, v, logw, u, initial_state=s0,
                                  kernel=kernel),
        lambda: rwkv6_scan_ref(r, k, v, logw, u, s0), "rwkv6_scan_kernel",
        rwkv_work(SLOTS, PROMPT, 40, 64, 64, 32, 2))
    t = dict(times["tiled"], variant="tiled")
    t["max_abs_err"] = held_tol(rwkv6_scan(r, k, v, logw, u,
                                           initial_state=s0)[0],
                                rwkv6_scan_ref(r, k, v, logw, u, s0)[0],
                                SCAN_TOL["bfloat16"])
    t["old"] = times["old"]
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


def serve_phase(dev, counters, arch: str) -> dict:
    """`arch` at full width through ServeEngine.serve: a serving main path
    with every launch count at 0 just before it, then the same weights
    through the plain path (kernels=False) for comparison."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import zoo
    from repro_torch.models.module import init_from_specs, param_bytes
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = cut(ARCHS[arch], DEPTH.get(arch))
    new, logits_tol = SERVED[arch]
    decode_steps = WAVES * (new - 1)
    specs = zoo.build_param_specs(cfg)
    t0 = time.perf_counter()
    params = init_from_specs(specs, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(5).integers(1, cfg.vocab,
                                                size=(N_REQ, PROMPT))

    def requests():
        return [Request(prompt=p, max_new_tokens=new) for p in prompts]

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
    per_prefill, per_step = zoo.kernel_launches(cfg)
    expected = {name: WAVES * per_prefill.get(name, 0)
                + decode_steps * per_step.get(name, 0) for name in counters}
    assert launches == expected, (launches, expected)
    for r in reqs:
        assert r.done and len(r.out_tokens) == new, r
        assert all(0 <= t < cfg.vocab for t in r.out_tokens)

    plain.caches = zoo_caches(zoo, cfg, dev)   # serve from zeros, as engine
    plain_reqs = plain.serve(requests())
    same = [a == b for r, p in zip(reqs, plain_reqs)
            for a, b in zip(r.out_tokens, p.out_tokens)]

    # the first wave's prefill logits, kernel path against plain path
    batch = {"tokens": torch.as_tensor(prompts[:SLOTS], device=dev)}
    logits = {}
    for name, use in (("kernels", None), ("plain", False)):
        logits[name], _ = zoo.prefill(cfg, params, batch,
                                      zoo_caches(zoo, cfg, dev), kernels=use)
    assert bool(torch.isfinite(logits["kernels"]).all())
    diff = float((logits["kernels"] - logits["plain"]).abs().max())
    logits_max = float(logits["plain"].abs().max())
    assert diff <= logits_tol, diff
    top2 = logits["plain"].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * logits_tol
    first_k = logits["kernels"].argmax(-1)
    first_p = logits["plain"].argmax(-1)
    assert torch.equal(first_k[clear], first_p[clear])
    assert arch in F32_CHECK or bool(clear.any()), "no first token compared"
    assert first_p.tolist() == [r.out_tokens[0] for r in plain_reqs[:SLOTS]]

    def timed_wave(eng):
        """Prefill ms and decode ms per step of one wave, with the engine's
        own host sync (one token read-back per step)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = eng.prefill_step(requests()[:SLOTS])
        tok.tolist()
        t1 = time.perf_counter()
        for _ in range(new - 1):
            tok = eng.decode_once(tok)
            tok.tolist()
        t2 = time.perf_counter()
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3 / (new - 1), tok

    waves = {name: timed_wave(eng)[:2] for name, eng in
             (("kernels", engine), ("plain", plain), ("kernels_again", engine),
              ("plain_again", plain))}

    # one prefill wave under the profiler: device busy ms, each port
    # kernel's share, and the scans' kernels by name
    pre_profile, pre_kernels = step_profile(
        lambda: engine.prefill_step(requests()[:SLOTS]).tolist())
    by_kernel = {}
    for name in counters:
        hits = [r for r in pre_kernels if f"{name}_kernel" in r[1]]
        by_kernel[name] = {"device_ms": sum(r[0] for r in hits) / 1e3,
                           "count": sum(r[2] for r in hits)}
    # the bf16 prefill runs the redesigned scans
    for name in ("ssd_scan", "rwkv6_scan"):
        if launches[name]:
            assert_variant(pre_kernels, f"{name}_kernel", "_tiled")
            assert by_kernel[name]["count"] == per_prefill[name]
    scan_ms = by_kernel["ssd_scan"]["device_ms"] + \
        by_kernel["rwkv6_scan"]["device_ms"]

    # one decode step under the profiler: device busy and idle share
    tok = engine.decode_once(engine.prefill_step(requests()[:SLOTS]))
    step, kernels = step_profile(lambda: engine.decode_once(tok).tolist())
    # the bf16 serving shapes run the redesigned kernels
    for name, suffix in (("moe_gemm", "_mma"), ("decode_attention", "_split")):
        if launches[name]:
            assert_variant(kernels, f"{name}_kernel", suffix)
    n_bytes = param_bytes(specs)
    out = {
        "phase": "serve", "arch": arch, **depth_line(cfg),
        "init_s": init_s, "requests": N_REQ,
        "batch_slots": SLOTS, "prompt_len": PROMPT, "max_len": MAX_LEN,
        "new_tokens": new, "waves": WAVES, "decode_steps": decode_steps,
        "wall_s": wall, "tokens_per_s": N_REQ * new / wall,
        "launches": launches,
        "prefill_ms": {k: v[0] for k, v in waves.items()},
        "decode_ms_per_step": {k: v[1] for k, v in waves.items()},
        "weights_bound_ms_per_step": n_bytes / HBM_BYTES_PER_S * 1e3,
        "max_memory_allocated": peak,
        "token_agreement_with_plain": sum(same) / len(same),
        "prefill_logits_max_abs_diff": diff, "logits_tol": logits_tol,
        "prefill_logits_max_abs": logits_max,
        "first_tokens_compared": int(clear.sum()),
        "prefill_profile": {
            **pre_profile, "port_kernels": by_kernel,
            "scan_device_ms": scan_ms,
            "scan_share": scan_ms / pre_profile["device_busy_ms"]},
        "decode_step_profile": step}
    del engine, plain, params, logits
    torch.cuda.empty_cache()
    if arch in F32_CHECK:
        out["float32_check"] = float32_check(
            dev, cut(ARCHS[arch], F32_CHECK[arch]))
    return out


def cut(cfg, n_layers):
    """`cfg` with its depth cut to `n_layers` (None keeps it)."""
    import dataclasses
    return cfg if n_layers is None else dataclasses.replace(cfg,
                                                            n_layers=n_layers)


def depth_line(cfg) -> dict:
    """The depth a phase ran and its parameters and bytes, beside the full
    model's where the depth was cut."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import zoo
    from repro_torch.models.module import param_bytes
    line = {"n_layers": cfg.n_layers, "params": cfg.param_count(),
            "param_bytes": param_bytes(zoo.build_param_specs(cfg))}
    full = ARCHS[cfg.name]
    if full.n_layers != cfg.n_layers:
        line["depth_cut"] = {
            "full_n_layers": full.n_layers, "full_params": full.param_count(),
            "full_param_bytes": param_bytes(zoo.build_param_specs(full))}
    return line


def float32_check(dev, cfg) -> dict:
    """`cfg` at full width and the depth it has, in float32, seeded
    weights: the kernel path's prefill and first decode logits against the
    plain path's, and
    the largest difference. The kernel path's prefill runs under the
    profiler, which shows that its scans ran their tiled kernels."""
    import dataclasses

    import torch
    from repro_torch.models import zoo
    from repro_torch.models.module import init_from_specs
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = init_from_specs(zoo.build_param_specs(cfg),
                             torch.Generator(device=dev).manual_seed(1),
                             device=dev)
    tokens = torch.as_tensor(np.random.default_rng(6).integers(
        1, cfg.vocab, size=(SLOTS, PROMPT)), device=dev)
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    wrappers = {"ssd_scan": ssd_scan, "rwkv6_scan": rwkv6_scan}
    out, scans = {}, {}
    for name, use in (("kernels", None), ("plain", False)):
        caches = zoo_caches(zoo, cfg, dev)
        got, before = [], {k: w.launches for k, w in wrappers.items()}
        _, rows = device_times(lambda: got.append(zoo.prefill(
            cfg, params, {"tokens": tokens}, caches, kernels=use)))
        pre, caches = got[0]
        dec, _ = zoo.decode_step(cfg, params, pre.argmax(-1)[:, None],
                                 caches, PROMPT, kernels=use)
        out[name] = (pre, dec)
        for scan, wrapper in wrappers.items():
            if use is None and wrapper.launches > before[scan]:
                # every launch of the float32 prefill ran the tiled kernel
                hits = [(k, c) for _, k, c in rows if f"{scan}_kernel" in k]
                assert hits and all(f"{scan}_kernel_tiled" in k
                                    for k, _ in hits), hits
                scans[scan] = sum(c for _, c in hits)
                assert scans[scan] == wrapper.launches - before[scan], \
                    (scan, scans[scan])
    diffs = [float((a - b).abs().max())
             for a, b in zip(out["kernels"], out["plain"])]
    assert max(diffs) <= F32_LOGITS_TOL, diffs
    res = {**depth_line(cfg), "dtype": "float32",
           "prefill_logits_max_abs_diff": diffs[0],
           "decode_logits_max_abs_diff": diffs[1],
           "logits_max_abs": float(out["plain"][0].abs().max()),
           "tol": F32_LOGITS_TOL, "tiled_scan_launches": scans}
    del params, out
    torch.cuda.empty_cache()
    return res


def whisper_inputs(cfg, dev):
    """The prompts (SLOTS, PROMPT) and seeded frame embeddings (SLOTS,
    enc_len, d_model) in `cfg`'s type."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(7)
    frames = torch.randn((SLOTS, cfg.enc["enc_len"], cfg.d_model),
                         generator=gen, device=dev).to(cfg.dtype)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        1, cfg.vocab, size=(SLOTS, PROMPT)), device=dev)
    return tokens, frames


def whisper_generate(cfg, params, tokens, frames, kernels, steps: int):
    """The reference's entry points (`tests/test_models.py:49-68`):
    `zoo.prefill` over the prompts and frames, `encdec.encode` for
    `enc_out`, then `steps` greedy `zoo.decode_step` calls. Returns the
    tokens (SLOTS, 1 + steps), the prefill and first decode step's logits,
    and ms of the prefill, of the encode and per decode step."""
    import torch
    from repro_torch.models import encdec, zoo
    caches = zoo_caches(zoo, cfg, tokens.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = zoo.prefill(cfg, params, {"tokens": tokens,
                                               "enc_embeds": frames},
                                 caches, kernels=kernels)
    tok = logits.argmax(-1)
    out = [tok.tolist()]
    t1 = time.perf_counter()
    enc = encdec.encode(cfg, params, frames, kernels=kernels)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    first = None
    for i in range(steps):
        lg, caches = zoo.decode_step(cfg, params, tok[:, None], caches,
                                     PROMPT + i, enc_out=enc, kernels=kernels)
        first = lg if first is None else first
        tok = lg.argmax(-1)
        out.append(tok.tolist())
    t3 = time.perf_counter()
    return {"tokens": np.array(out).T, "prefill": logits, "decode": first,
            "prefill_ms": (t1 - t0) * 1e3, "encode_ms": (t2 - t1) * 1e3,
            "decode_ms_per_step": (t3 - t2) * 1e3 / max(steps, 1),
            "cross_cache_max_abs": float(caches["cross_k"].abs().max())}


def whisper_uncached(cfg, params, tokens, frames, kernels):
    """The uncached forward, where cross attention reads the encoder output:
    `encode`, `decode_stack(caches=None)`, float32 logits at every
    position."""
    from repro_torch.models import encdec
    from repro_torch.models.transformer import logits_f32
    enc = encdec.encode(cfg, params, frames, kernels=kernels)
    hidden, _ = encdec.decode_stack(cfg, params, tokens, enc,
                                    kernels=kernels)
    return logits_f32(hidden, params["embed"])


def whisper_phase(dev, counters) -> dict:
    """whisper-large-v3 at full width and depth, bf16 seeded weights: the
    serving entry points with every launch count at 0 just before them,
    the plain path on the same inputs, the uncached forward both ways, a
    profiled prefill and decode step, then the float32 gate at full
    depth (cached and uncached passes)."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import zoo
    from repro_torch.models.module import init_from_specs, param_bytes
    cfg = ARCHS[WHISPER]
    t0 = time.perf_counter()
    params = init_from_specs(zoo.build_param_specs(cfg),
                             torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens, frames = whisper_inputs(cfg, dev)
    for use in (None, False):                                   # warm-up
        whisper_generate(cfg, params, tokens, frames, use, 1)

    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = whisper_generate(cfg, params, tokens, frames, None, WHISPER_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    per_prefill, per_step = zoo.kernel_launches(cfg)
    expected = {name: per_prefill.get(name, 0) + WHISPER_NEW *
                per_step.get(name, 0) for name in counters}
    expected["flash_attention"] += cfg.enc["enc_layers"]   # the encode
    assert launches == expected, (launches, expected)
    assert run["tokens"].shape == (SLOTS, 1 + WHISPER_NEW)
    assert ((0 <= run["tokens"]) & (run["tokens"] < cfg.vocab)).all()
    assert bool(torch.isfinite(run["prefill"]).all())
    # as in the reference, prefill leaves the cross K/V cache at zero
    assert run["cross_cache_max_abs"] == 0.0

    plain = whisper_generate(cfg, params, tokens, frames, False, WHISPER_NEW)
    pre_diff = float((run["prefill"] - plain["prefill"]).abs().max())
    dec_diff = float((run["decode"] - plain["decode"]).abs().max())
    same = float((run["tokens"] == plain["tokens"]).mean())
    unc = {name: whisper_uncached(cfg, params, tokens, frames, use)
           for name, use in (("kernels", None), ("plain", False))}
    assert bool(torch.isfinite(unc["kernels"]).all())
    unc_diff = float((unc["kernels"] - unc["plain"]).abs().max())
    diffs = {"prefill": pre_diff, "decode": dec_diff, "uncached": unc_diff}
    assert all(diffs[k] <= WHISPER_TOL[k] for k in diffs), diffs
    # the encoder output reaches the uncached logits only
    enc_effect = float((unc["plain"][:, -1] - plain["prefill"]).abs().max())
    del unc
    timed_runs = {name: whisper_generate(cfg, params, tokens, frames, use,
                                         WHISPER_NEW)
                  for name, use in (("kernels", None), ("plain", False),
                                    ("kernels_again", None),
                                    ("plain_again", False))}

    batch = {"tokens": tokens, "enc_embeds": frames}
    caches = zoo_caches(zoo, cfg, dev)

    pre_profile, pre_kernels = step_profile(
        lambda: zoo.prefill(cfg, params, batch,
                            caches)[0].argmax(-1).tolist())
    from repro_torch.models import encdec
    enc = encdec.encode(cfg, params, frames)
    tok = tokens[:, -1:]
    step, kernels = step_profile(
        lambda: zoo.decode_step(cfg, params, tok, caches, PROMPT,
                                enc_out=enc)[0].argmax(-1).tolist())
    assert_variant(pre_kernels + kernels, "flash_attention_kernel", "_mma")
    assert_variant(kernels, "decode_attention_kernel", "_split")
    # the weights a cached decode step reads: the decoder without its cross
    # K/V projections (their output is in the cache), and the tied embedding
    specs = zoo.build_param_specs(cfg)
    cross = specs["dec_layers"]["cross"]
    n_bytes = (param_bytes(specs["dec_layers"]) + param_bytes(specs["dec_norm"])
               + param_bytes(specs["embed"])
               - param_bytes({"wk": cross["wk"], "wv": cross["wv"]}))
    out = {
        "phase": "whisper", "arch": WHISPER, **depth_line(cfg),
        "enc_layers": cfg.enc["enc_layers"], "enc_len": cfg.enc["enc_len"],
        "init_s": init_s, "batch": SLOTS, "prompt_len": PROMPT,
        "max_len": MAX_LEN, "decode_steps": WHISPER_NEW, "wall_s": wall,
        "tokens_per_s": SLOTS * WHISPER_NEW / wall, "launches": launches,
        "prefill_ms": {k: v["prefill_ms"] for k, v in timed_runs.items()},
        "encode_ms": {k: v["encode_ms"] for k, v in timed_runs.items()},
        "decode_ms_per_step": {k: v["decode_ms_per_step"]
                               for k, v in timed_runs.items()},
        "weights_bound_ms_per_step": n_bytes / HBM_BYTES_PER_S * 1e3,
        "max_memory_allocated": peak,
        "token_agreement_with_plain": same,
        "prefill_logits_max_abs_diff": pre_diff,
        "decode_logits_max_abs_diff": dec_diff,
        "uncached_logits_max_abs_diff": unc_diff, "logits_tol": WHISPER_TOL,
        "encoder_effect_on_last_logits": enc_effect,
        "prefill_logits_max_abs": float(plain["prefill"].abs().max()),
        "cross_cache_max_abs": run["cross_cache_max_abs"],
        "prefill_profile": pre_profile, "decode_step_profile": step}
    del params, run, plain, timed_runs, caches, enc
    torch.cuda.empty_cache()

    # the float32 gate at full depth: the cached entry points and the
    # uncached forward, kernel path against plain path
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = init_from_specs(zoo.build_param_specs(cfg),
                             torch.Generator(device=dev).manual_seed(1),
                             device=dev)
    tokens, frames = whisper_inputs(cfg, dev)
    got = {name: whisper_generate(cfg, params, tokens, frames, use, 1)
           for name, use in (("kernels", None), ("plain", False))}
    unc = {name: whisper_uncached(cfg, params, tokens, frames, use)
           for name, use in (("kernels", None), ("plain", False))}
    diffs = {"prefill": float((got["kernels"]["prefill"]
                               - got["plain"]["prefill"]).abs().max()),
             "decode": float((got["kernels"]["decode"]
                              - got["plain"]["decode"]).abs().max()),
             "uncached": float((unc["kernels"] - unc["plain"]).abs().max())}
    assert max(diffs.values()) <= F32_LOGITS_TOL, diffs
    out["float32_check"] = {
        **depth_line(cfg), "dtype": "float32",
        **{f"{k}_logits_max_abs_diff": v for k, v in diffs.items()},
        "logits_max_abs": float(unc["plain"].abs().max()),
        "tol": F32_LOGITS_TOL}
    del params, got, unc
    torch.cuda.empty_cache()
    return out


def zoo_caches(zoo, cfg, dev):
    """Zeroed caches of the serving shape."""
    from repro_torch.models.module import init_from_specs
    return init_from_specs(zoo.build_cache_specs(cfg, SLOTS, MAX_LEN), 0,
                           device=dev)


@contextlib.contextmanager
def counted_chunks():
    """Keep the prefilter chunks `BatchedFitness` scores (one wavefront_scan
    launch each on the fused route) while the block runs: yields a list that
    gains `(fitness, genomes, latency, energy)` for each chunk."""
    from repro_torch.core.vectorized import BatchedFitness
    chunks = []
    score = BatchedFitness._score

    def counted(self, genomes):
        lat, en = score(self, genomes)
        chunks.append((self, genomes, lat, en))
        return lat, en

    BatchedFitness._score = counted
    try:
        yield chunks
    finally:
        BatchedFitness._score = score


@contextlib.contextmanager
def plain_prefilter():
    """Every prefilter fitness built while the block runs scores through
    the plain PyTorch loop (`use_kernel=False`) on the same device."""
    from repro_torch.core import vectorized
    build = vectorized.get_batched_fitness
    vectorized.get_batched_fitness = functools.partial(build, use_kernel=False)
    try:
        yield
    finally:
        vectorized.get_batched_fitness = build


def hold_chunks_against_plain(chunks, counters) -> dict:
    """Score each chunk the sweep gave `wavefront_scan` again through the
    plain PyTorch loop of the same fitness (`use_kernel=False`, same device,
    same contention model): latency and energy must be bit-equal, as the
    fitness phase finds at its 256-genome chunk.  Launches no kernel."""
    import torch

    from repro_torch.core.vectorized import get_batched_fitness
    before = {name: fn.launches for name, fn in counters.items()}
    max_abs, shapes = 0.0, set()
    for bf, genomes, lat, en in chunks:
        assert bf.route == "fused", bf.route
        plain = get_batched_fitness(
            bf.engine, priority=bf.priority, segment=bf.segment,
            strict_layers=bf.strict_layers, use_kernel=False,
            contention=bf.contention, device=bf.device)
        assert plain.route == "plain", plain.route
        p_lat, p_en = plain._score(genomes)
        for got, want in ((lat, p_lat), (en, p_en)):
            max_abs = max(max_abs, float((got - want).abs().max()))
            assert torch.equal(got, want), (bf.engine.graph.n, got, want)
        shapes.add(tuple(genomes.shape))
    assert {n: fn.launches for n, fn in counters.items()} == before
    return {"chunks": len(chunks), "shapes": sorted(shapes),
            "max_abs_err": max_abs, "bit_equal": True}


def record_content(record) -> dict:
    """A sweep record's stored fields but `runtime_s` (wall time)."""
    d = record.to_dict()
    d.pop("runtime_s")
    return d


def sweep_phase(counters, work_dir) -> tuple:
    """The paper's exploration grid through the port's DSE runtime on the
    card: prefiltered, traced, serial, into a store on disk; then a fresh
    session over the same store.  Returns the phase's line, the session
    and the space (the Chrome trace reads the best fused record's
    schedule from them)."""
    import torch

    from repro_torch.api import (DesignSpace, ExplorationSession, GAConfig,
                                 granularity_label)
    from repro_torch.configs.paper_workloads import EXPLORATION_WORKLOADS
    from repro_torch.hw.catalog import EXPLORATION_ARCHITECTURES
    from repro_torch.obs import Tracer

    space = DesignSpace(workloads=EXPLORATION_WORKLOADS,
                        archs=EXPLORATION_ARCHITECTURES,
                        granularities=["layer", GRAN],
                        ga=GAConfig(**SWEEP_GA))
    assert len(space) == SWEEP_POINTS, space
    store = os.path.join(work_dir, "grid")
    tracer = Tracer()
    session = ExplorationSession(cache_dir=store, prefilter=True,
                                 tracer=tracer)
    with counted_chunks() as chunks:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep = session.run(space)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    counts = tracer.snapshot()["counters"]
    assert len(sweep) == SWEEP_POINTS and sweep.n_failed == 0, sweep
    assert sweep.n_scheduled == SWEEP_POINTS, sweep.n_scheduled
    assert launches["wavefront_scan"] == len(chunks) > 0, (launches,
                                                           len(chunks))
    assert all(n == 0 for name, n in launches.items()
               if name != "wavefront_scan"), launches
    # the kernel against its plain version at every chunk the sweep gave it
    chunk_check = hold_chunks_against_plain(chunks, counters)
    del chunks

    # the same grid with the prefilter on the plain loop, into a store of
    # its own: every record and every tracer counter as the kernel's run
    plain_tracer = Tracer()
    t0 = time.perf_counter()
    with plain_prefilter():
        plain = ExplorationSession(cache_dir=os.path.join(work_dir, "plain"),
                                   prefilter=True, tracer=plain_tracer
                                   ).run(space)
    plain_wall = time.perf_counter() - t0
    assert sum(fn.launches for fn in counters.values()) == sum(
        launches.values())
    assert [record_content(r) for r in plain.records] == \
        [record_content(r) for r in sweep.records]
    assert plain_tracer.snapshot()["counters"] == counts, (
        plain_tracer.snapshot()["counters"], counts)
    # every stored metric comes from the exact engine
    for point, rec in zip(space, sweep.records):
        assert rec.key == point.content_key()
        exact = session.evaluate_allocation(
            point.workload, point.arch, rec.allocation,
            granularity=point.granularity, priority=point.priority)
        assert (rec.latency_cc, rec.energy_pj) == (
            float(exact.latency_cc), float(exact.energy_pj)), rec
        assert np.isfinite(rec.edp) and rec.edp > 0
    fused = granularity_label(GRAN)
    by_cell = {(r.arch, r.workload, r.granularity): r for r in sweep.records}
    gains = {}
    for arch in EXPLORATION_ARCHITECTURES:
        ratios = [by_cell[(arch, w, "layer")].edp / by_cell[(arch, w, fused)].edp
                  for w in EXPLORATION_WORKLOADS]
        gains[arch] = float(np.exp(np.mean(np.log(ratios))))

    # a fresh session over the same store: nothing scheduled, no launch
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    replay = ExplorationSession(cache_dir=store, prefilter=True).run(space)
    replay_wall = time.perf_counter() - t0
    replay_launches = sum(fn.launches for fn in counters.values())
    assert (replay.n_from_store, replay.n_scheduled, replay_launches) == (
        SWEEP_POINTS, 0, 0), (replay.n_from_store, replay.n_scheduled,
                              replay_launches)
    assert [record_content(r) for r in replay.records] == \
        [record_content(r) for r in sweep.records]

    # the grid once more under the profiler, in a memory-only session: the
    # card's busy time beside the sweep's wall time
    wall_ms, rows = device_times(
        lambda: ExplorationSession(prefilter=True).run(space))
    kernels = [r for r in rows if not r[1].startswith("aten::")]
    busy = sum(r[0] for r in kernels) / 1e3
    scan = [(us, c) for us, k, c in kernels if "wavefront_scan" in k]
    profile = {"wall_ms": wall_ms, "device_busy_ms": busy,
               "device_idle_share": 1 - busy / wall_ms,
               "kernel_launches": sum(r[2] for r in kernels),
               "wavefront_scan_device_ms": sum(us for us, _ in scan) / 1e3,
               "wavefront_scan_launches": sum(c for _, c in scan),
               "top": [{"name": k[:90], "device_ms": us / 1e3, "count": c}
                       for us, k, c in kernels[:6]]}
    return {"phase": "sweep", "points": len(sweep),
            "grid": {"workloads": list(EXPLORATION_WORKLOADS),
                     "archs": list(EXPLORATION_ARCHITECTURES),
                     "granularities": ["layer", fused], **SWEEP_GA},
            "wall_s": wall, "points_per_s": len(sweep) / wall,
            "launches": launches["wavefront_scan"],
            "prefilter_chunks": chunk_check["chunks"],
            "chunks_vs_plain": chunk_check,
            "plain_sweep": {"wall_s": plain_wall, "records_equal": True,
                            "counters_equal": True},
            "points_with_ga": sum(1 for r in sweep.records
                                  if r.ga_evaluations),
            "ga_evaluations": sum(r.ga_evaluations for r in sweep.records),
            "geomean_edp_gain_layer_over_fused": gains,
            "tracer_counters": counts,
            "replay": {"wall_s": replay_wall,
                       "from_store": replay.n_from_store,
                       "scheduled": replay.n_scheduled,
                       "launches": replay_launches},
            "profile": profile,
            "best_fused": min((r for r in sweep.records
                               if r.granularity == fused),
                              key=lambda r: r.edp).key}, session, space


def distributed_phase(work_dir, grid_session, grid_space,
                      best_key) -> tuple:
    """examples/distributed_sweep.py's space through the process executor
    (spawned workers beside this CUDA-holding process), under a seeded
    fault schedule, and through 2 shards; then a Chrome trace of the best
    fused record of the grid.  Returns (the phase's line, the serial run's
    record contents)."""
    from repro_torch.analysis.staticcheck.racecheck import validate_trace
    from repro_torch.api import (DesignSpace, ExplorationSession,
                                 FaultInjector, GAConfig, RetryPolicy,
                                 build_manifest, merge_stores, run_shard)
    from repro_torch.core.vectorized import get_batched_fitness
    from repro_torch.hw.catalog import EXPLORATION_ARCHITECTURES
    from repro_torch.obs import (bottleneck_report, trace_schedule,
                                 validate_trace_events, write_chrome_trace)

    space = DesignSpace(workloads=list(DIST_WORKLOADS),
                        archs=EXPLORATION_ARCHITECTURES,
                        granularities=["layer", GRAN],
                        ga=GAConfig(**DIST_GA))
    t0 = time.perf_counter()
    serial = ExplorationSession().run(space)
    serial_wall = time.perf_counter() - t0
    want = [record_content(r) for r in serial.records]
    assert len(want) == 28 and serial.n_failed == 0

    t0 = time.perf_counter()
    pooled = ExplorationSession().run(space, executor="process",
                                      max_workers=2)
    pooled_wall = time.perf_counter() - t0
    assert pooled.n_failed == 0
    assert [record_content(r) for r in pooled.records] == want

    # worker kills on 4 points (the pool rebuilt), and one straggler whose
    # first attempt sleeps far past the deadline (re-dispatched; 5 s leave
    # a fresh spawned worker the time to import and compute the point)
    faults = {}
    for name, n, inj, deadline in (
            ("kills", 4, FaultInjector(seed=3, kill_rate=1.0,
                                       max_faults_per_point=1), None),
            ("deadline", 1, FaultInjector(seed=0, delay_rate=1.0,
                                          delay_s=20.0,
                                          max_faults_per_point=1), 5.0)):
        t0 = time.perf_counter()
        got = ExplorationSession(retry_policy=RetryPolicy(max_attempts=3),
                                 fault_injector=inj, deadline_s=deadline
                                 ).run(list(space)[:n], executor="process",
                                       max_workers=2)
        faults[name] = {"points": n, "wall_s": time.perf_counter() - t0,
                        "retried": got.n_retried, "failed": got.n_failed}
        assert got.n_failed == 0 and got.n_retried >= 1, faults
        assert faults[name]["wall_s"] < 20.0, faults
        assert [record_content(r) for r in got.records] == want[:n]

    manifest = build_manifest(space, order="nearest-arch").save(
        os.path.join(work_dir, "sweep.json"))
    t0 = time.perf_counter()
    shards = [os.path.join(work_dir, f"shard{k}") for k in range(2)]
    for k, d in enumerate(shards):
        assert run_shard(manifest, cache_dir=d, shard=(k, 2)).n_failed == 0
    merged = merge_stores(os.path.join(work_dir, "merged"), *shards)
    shard_wall = time.perf_counter() - t0
    by_key = {r.key: record_content(r) for r in merged.values()}
    assert len(by_key) == len(want)
    assert [by_key[r["key"]] for r in want] == want

    # the best fused record of the grid: its schedule traced and checked
    point = next(p for p in grid_space if p.content_key() == best_key)
    rec = grid_session.store.get(best_key)
    engine = grid_session.engine(point.workload, point.arch,
                                 point.granularity)
    events, result = trace_schedule(engine, rec.allocation, rec.priority)
    assert (result.latency_cc, result.energy_pj) == (rec.latency_cc,
                                                     rec.energy_pj)
    assert validate_trace_events(events) == []
    race = validate_trace(result, engine.graph, engine.accelerator,
                          point.workload)
    path = write_chrome_trace(events, os.path.join(work_dir, "best.json"))
    bf = get_batched_fitness(engine, priority=rec.priority)
    lb = float(bf.latency_lower_bound(np.asarray(rec.allocation)[None, :])[0])
    report = bottleneck_report(result, lower_bound_cc=lb)
    return {"phase": "distributed", "points": len(want),
            "serial_wall_s": serial_wall,
            "process": {"workers": 2, "wall_s": pooled_wall},
            "faults": faults,
            "shards": {"n": 2, "wall_s": shard_wall, "merged": len(by_key)},
            "trace": {"workload": point.workload_name,
                      "arch": point.arch.name, "events": len(events),
                      "bytes": os.path.getsize(path), "racecheck": race},
            "bottleneck": report.to_dict()}, want


def simulate_phase() -> dict:
    """The serving simulator's CLI for each family, twice: equal both times."""
    import io

    from repro_torch.launch.serve import main as serve_main

    out = {}
    for family in FAMILIES:
        runs = []
        t0 = time.perf_counter()
        for _ in range(2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                sweep = serve_main(["--simulate", "--family", family])
            runs.append((buf.getvalue(),
                         [r.to_dict() for r in sweep.records]))
        assert runs[0] == runs[1], family
        rec = sweep.records[0]
        assert len(sweep.records) == 1 and rec.qps > 0, sweep.records
        out[family] = {"p50_ms": rec.p50_ms, "p99_ms": rec.p99_ms,
                       "qps": rec.qps, "rate_rps": rec.rate_rps,
                       "slo_attainment": rec.slo_attainment,
                       "energy_per_request_pj": rec.energy_per_request_pj,
                       "wall_s": (time.perf_counter() - t0) / 2}
    return {"phase": "simulate", "families": out}


def tools_phase(work_dir, want, counters, device: str = "cuda") -> dict:
    """The port's sweep CLIs in this process, as a user runs them with
    `python -m repro_torch.tools.<name>`: examples/distributed_sweep.py's
    28-point manifest through `run_shard` as shards 0/2 and 1/2 with
    heartbeats, `merge_stores` (and `--verify`, and a corrupt copy refused
    with exit 4, a missing source with exit 2), `sweep_top --once` over
    the two heartbeats and `trace_export` twice.  The merged records equal
    the distributed phase's serial run key for key, byte for byte; the
    CLIs run unfiltered, as the reference's do, so no kernel launches."""
    import io
    import shutil

    from repro_torch.api import (DesignSpace, GAConfig, ResultStore,
                                 build_manifest)
    from repro_torch.hw.catalog import EXPLORATION_ARCHITECTURES
    from repro_torch.tools import (merge_stores, run_shard, sweep_top,
                                   trace_export)

    t0 = time.perf_counter()
    root = os.path.join(work_dir, "tools")
    os.makedirs(root)
    space = DesignSpace(workloads=list(DIST_WORKLOADS),
                        archs=EXPLORATION_ARCHITECTURES,
                        granularities=["layer", GRAN],
                        ga=GAConfig(**DIST_GA))
    manifest = build_manifest(space).save(os.path.join(root, "sweep.json"))
    shards = [os.path.join(root, f"shard{k}") for k in range(2)]
    beats = [os.path.join(d, "heartbeat.json") for d in shards]
    merged = os.path.join(root, "merged")
    bad = os.path.join(root, "corrupt")
    codes, walls, outs = {}, {}, {}

    def cli(name, main, argv, want_rc):
        buf, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = main(argv)
        walls[name] = time.perf_counter() - t0
        codes[name] = rc
        outs[name] = buf.getvalue()
        assert rc == want_rc, (name, rc, buf.getvalue(), err.getvalue())

    for fn in counters.values():
        fn.launches = 0
    for k, d in enumerate(shards):
        cli(f"run_shard {k}/2", run_shard.main,
            [manifest, "--shard", f"{k}/2", "--out", d,
             "--heartbeat", beats[k]], 0)
    cli("merge_stores", merge_stores.main, [merged] + shards, 0)
    cli("merge_stores --verify", merge_stores.main,
        [os.path.join(root, "verified")] + shards + ["--verify"], 0)
    shutil.copytree(shards[0], bad)
    path = ResultStore.resolve_path(bad)
    lines = open(path).read().splitlines(True)
    with open(path, "w") as f:
        f.writelines(lines[:1] + ["garbage\n"] + lines[1:])
    cli("merge_stores --verify corrupt", merge_stores.main,
        [os.path.join(root, "refused"), bad, "--verify"], 4)
    cli("merge_stores missing", merge_stores.main,
        [os.path.join(root, "none"), os.path.join(root, "missing")], 2)
    cli("sweep_top --once", sweep_top.main,
        beats + ["--stores"] + shards + ["--once"], 0)
    blobs = []
    for run in ("a", "b"):
        cli(f"trace_export {run}", trace_export.main,
            ["--out", os.path.join(root, f"trace_{run}"), "--device",
             device], 0)
        blobs.append({f: open(os.path.join(root, f"trace_{run}", f),
                              "rb").read()
                      for f in ("schedule_trace.json", "serving_trace.json",
                                "bottleneck.json", "bottleneck.txt")})
    assert blobs[0] == blobs[1]
    launches = {name: fn.launches for name, fn in counters.items()}
    assert not any(launches.values()), launches

    got = {r.key: json.dumps(record_content(r), sort_keys=True)
           for r in ResultStore(merged).values()}
    serial = {r["key"]: json.dumps(r, sort_keys=True) for r in want}
    assert got == serial
    top = outs["sweep_top --once"]
    assert "fleet: 2/2 live" in top and f"done {len(want)}/{len(want)}" in \
        top, top
    beat = [json.load(open(b)) for b in beats]
    assert all(b["status"] == "done" for b in beat)
    return {"phase": "tools", "points": len(want), "exit_codes": codes,
            "wall_s": time.perf_counter() - t0, "cli_wall_s": walls,
            "merged_equal_serial": True,
            "heartbeats": [{k: b.get(k) for k in ("done", "failed", "total",
                                                   "status")} for b in beat],
            "sweep_top": top.splitlines()[-1],
            "trace_bytes": {k: len(v) for k, v in blobs[0].items()},
            "launches": launches}


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def seeded_params(cfg, dev, seed: int = 0):
    """`cfg`'s parameters drawn on `dev` from `seed`."""
    import torch
    from repro_torch.models import zoo
    from repro_torch.models.module import init_from_specs
    return init_from_specs(zoo.build_param_specs(cfg),
                           torch.Generator(device=dev).manual_seed(seed),
                           device=dev)


def mesh_serve(dev, counters, mesh, cfg) -> dict:
    """`cfg` through `ServeEngine(mesh=)` and the mesh-free engine on the
    same weights: the same tokens and every kernel's launches the same."""
    from repro_torch.serve.engine import Request, ServeEngine
    params = seeded_params(cfg, dev)
    new = SERVED.get(cfg.name, (4,))[0]
    prompts = np.random.default_rng(5).integers(1, cfg.vocab,
                                                size=(N_REQ, PROMPT))
    kw = dict(batch_slots=SLOTS, prompt_len=PROMPT, max_len=MAX_LEN,
              device=dev)
    out = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        eng = ServeEngine(cfg, params, mesh=m, **kw)
        if m is not None:
            assert eng.params["embed"] is params["embed"]
        for fn in counters.values():
            fn.launches = 0
        sync(dev)
        t0 = time.perf_counter()
        reqs = eng.serve([Request(prompt=p, max_new_tokens=new)
                          for p in prompts])
        sync(dev)
        out[name] = {"wall_s": time.perf_counter() - t0,
                     "tokens": [r.out_tokens for r in reqs],
                     "launches": {k: fn.launches
                                  for k, fn in counters.items()}}
        del eng
    assert out["mesh"]["tokens"] == out["plain"]["tokens"]
    assert out["mesh"]["launches"] == out["plain"]["launches"]
    assert any(out["mesh"]["launches"].values()) or dev.type != "cuda"
    del params
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "requests": N_REQ,
            "new_tokens": new, "tokens_equal": True,
            "tokens": out["mesh"]["tokens"],
            "launches": out["mesh"]["launches"],
            "wall_s": {k: v["wall_s"] for k, v in out.items()}}


def kv_decode(cfg, params, mesh, dev, kv: bool, steps: int = 4,
              kernels=None, sharded: bool = False):
    """`zoo.prefill` of SLOTS seeded prompts, then `steps` greedy
    `decode_step`s on `mesh` (its caches laid out by
    `zoo.cache_shardings`), split-KV or not, from whole `params` (or this
    rank's blocks, `sharded`): (every step's logits, decode ms per
    step)."""
    import torch
    from repro_torch.models import zoo
    from repro_torch.models.module import init_from_specs
    from repro_torch.models.transformer import param_shardings
    from repro_torch.sharding.rules import local_specs, shard_tree
    p = params if sharded else shard_tree(params,
                                          param_shardings(cfg, mesh))
    caches = init_from_specs(local_specs(
        zoo.build_cache_specs(cfg, SLOTS, MAX_LEN),
        zoo.cache_shardings(cfg, SLOTS, MAX_LEN, mesh, kv)), 0, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(6).integers(
        1, cfg.vocab, size=(SLOTS, PROMPT)), device=dev)
    logits, caches = zoo.prefill(cfg, p, {"tokens": tokens}, caches,
                                 mesh=mesh, kv_seq_shard=kv, kernels=kernels)
    out = [logits]
    sync(dev)
    t0 = time.perf_counter()
    for t in range(steps):
        logits, caches = zoo.decode_step(
            cfg, p, out[-1].argmax(-1)[:, None], caches, PROMPT + t,
            mesh=mesh, kv_seq_shard=kv, kernels=kernels)
        out.append(logits)
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3 / steps


def mesh_kv(dev, mesh, cfg) -> dict:
    """`decode_step(kv_seq_shard=True)` against `kv_seq_shard=False` on
    `mesh`, `cfg` in float32 (TF32 off): every step's logits within
    F32_LOGITS_TOL."""
    import dataclasses

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = seeded_params(cfg, dev, 1)
    kv, kv_ms = kv_decode(cfg, params, mesh, dev, True)
    rows, rows_ms = kv_decode(cfg, params, mesh, dev, False)
    diffs = [float((a - b).abs().max()) for a, b in zip(kv, rows)]
    assert max(diffs) <= F32_LOGITS_TOL, diffs
    assert all(bool(torch.isfinite(x).all()) for x in kv)
    del params
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": "float32",
            "steps": len(kv) - 1, "max_abs_diff": max(diffs),
            "diffs": diffs, "tol": F32_LOGITS_TOL,
            "logits_max_abs": float(rows[0].abs().max()),
            "decode_ms_per_step": {"kv_seq_shard": kv_ms, "plain": rows_ms}}


def moe_inputs(cfg, dev):
    """One MoE layer of `cfg` at full width, seeded, a prefill wave's
    tokens and `moe_ffn`'s keywords: (params, x, kw)."""
    import torch
    from repro_torch.models.layers import moe_specs
    from repro_torch.models.module import init_from_specs
    m = cfg.moe
    params = init_from_specs(
        moe_specs(cfg.d_model, m["d_ff_expert"], m["n_routed"],
                  m["n_shared"], cfg.dtype),
        torch.Generator(device=dev).manual_seed(2), device=dev)
    x = (torch.randn(SLOTS, PROMPT, cfg.d_model, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(3))
         .to(cfg.dtype))
    return params, x, dict(top_k=m["top_k"],
                           capacity_factor=m.get("capacity_factor", 1.25))


def mesh_moe(dev, counters, mesh, cfg) -> dict:
    """One MoE layer of `cfg` at full width (seeded weights, a prefill
    wave's tokens) through `moe_ffn(mesh=)` with the kernels: equal to the
    mesh-free call bit for bit, three `moe_gemm` launches, each of the
    tensor-core variant."""
    import torch
    from repro_torch.models.layers import moe_ffn
    m = cfg.moe
    params, x, kw = moe_inputs(cfg, dev)
    use = dev.type == "cuda"
    counters["moe_gemm"].launches = 0
    got, aux = moe_ffn(params, x, mesh=mesh, kernels=use, **kw)
    launches = counters["moe_gemm"].launches
    want, want_aux = moe_ffn(params, x, kernels=use, **kw)
    assert torch.equal(got, want) and float(aux) == float(want_aux)
    plain, _ = moe_ffn(params, x, mesh=mesh, kernels=False, **kw)
    err = float((got.float() - plain.float()).abs().max())
    assert err <= SERVE_TOL["bfloat16"] * max(1.0, float(
        plain.float().abs().max())), err
    out = {"arch": cfg.name, "d_model": cfg.d_model,
           "d_ff_expert": m["d_ff_expert"], "experts": m["n_routed"],
           "tokens": SLOTS * PROMPT, "launches": launches,
           "equal_to_mesh_free": True, "max_abs_err_vs_plain": err}
    if use:
        assert launches == 3, launches
        _, kernels = step_profile(
            lambda: moe_ffn(params, x, mesh=mesh, kernels=True, **kw))
        assert_variant(kernels, "moe_gemm_kernel", "_mma")
        out["variant"] = "_mma"
    del params
    return out, got


def pipeline_run(cfg, params, mesh, dev, *, batch, seq, microbatches,
                 backward: bool = True):
    """The GPipe loss of `cfg` on `mesh` ("pipe" stages) over
    TokenStream's batch 0, remat on, and its gradients: (loss, grads
    list, ms).  `params` is whole; each stage takes its layers."""
    import torch
    from repro_torch.models.module import tree_leaves, tree_map, \
        tree_unflatten
    from repro_torch.train.pipeline import make_pipeline_loss
    n = mesh.size("pipe")
    stage = mesh.index("pipe")
    local = dict(params)
    local["layers"] = tree_map(
        lambda a: a.reshape((n, -1) + a.shape[1:])[stage:stage + 1],
        params["layers"])
    leaves = [p.detach().requires_grad_(backward) for p in
              tree_leaves(local)]
    local = tree_unflatten(local, leaves)
    fn = make_pipeline_loss(cfg, mesh, n_stages=n,
                            n_microbatches=microbatches, remat=True)
    data = token_batch(cfg, 0, batch, seq, dev)
    sync(dev)
    t0 = time.perf_counter()
    with torch.set_grad_enabled(backward):
        loss = fn(local, data)
        grads = torch.autograd.grad(loss, leaves) if backward else []
    sync(dev)
    return float(loss.detach()), grads, (time.perf_counter() - t0) * 1e3


def mesh_pipeline(dev, cfg, gate_cfg) -> dict:
    """The pipeline at one stage on a one-rank ("pipe", "data") mesh
    against `zoo.train_loss`: `cfg` in bf16 at PIPE's shape (loss within
    1e-3, times of the second pipeline run and of `train_loss` and its
    gradients after it), `gate_cfg` in float32 (loss 1e-5 relative,
    gradients 1e-4 of each leaf's largest magnitude)."""
    import dataclasses

    import torch
    from repro_torch.models import zoo
    from repro_torch.models.module import tree_leaves
    from repro_torch.sharding.rules import Mesh
    mesh = Mesh((1, 1), ("pipe", "data"), device_type=dev.type)
    shape = dict(batch=PIPE["batch"], seq=PIPE["seq"],
                 microbatches=PIPE["microbatches"])
    out = {}
    for name, c in (("bf16", cfg), ("float32", dataclasses.replace(
            gate_cfg, dtype=torch.float32))):
        params = seeded_params(c, dev, 4)
        pipeline_run(c, params, mesh, dev, **shape)          # warm-up
        loss, grads, ms = pipeline_run(c, params, mesh, dev, **shape)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        from repro_torch.models.module import tree_unflatten
        data = token_batch(c, 0, PIPE["batch"], PIPE["seq"], dev)
        sync(dev)
        t0 = time.perf_counter()
        want = zoo.train_loss(c, tree_unflatten(params, leaves), data)
        want_g = torch.autograd.grad(want, leaves)
        sync(dev)
        ref_ms = (time.perf_counter() - t0) * 1e3
        want = want.detach()
        res = {"n_layers": c.n_layers, "loss": loss, "train_loss":
               float(want), "ms": ms, "train_loss_ms": ref_ms}
        if name == "bf16":
            assert abs(loss - float(want)) < 1e-3, res
        else:
            assert abs(loss - float(want)) <= 1e-5 * abs(float(want)), res
            worst = 0.0
            for g, w in zip(grads, want_g):
                w = w.reshape(g.shape)
                worst = max(worst, float((g - w).abs().max()) /
                            max(float(w.abs().max()), 1e-30))
            assert worst <= 1e-4, worst
            res["grad_rel_diff"] = worst
        out[name] = res
        del params, grads, want_g, leaves
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"stages": 1, **{k: PIPE[k] for k in ("batch", "seq",
                                                 "microbatches")}, **out}


def in_turn(make):
    """`make()` on each rank of the process group in turn, the others
    waiting, so the card holds one rank's transient copies at a time."""
    import torch
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = make()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def tp_local_heads(cfg, mixer) -> int:
    """The heads a rank's stacked mixer blocks hold: `wq`'s columns (GQA,
    MLA), Mamba2's `out_proj` rows, RWKV6's `Wr` columns, over the width
    of a head."""
    if cfg.mixer == "mamba2":
        return mixer["out_proj"].shape[1] // cfg.ssm["headdim"]
    if cfg.mixer == "rwkv6":
        return mixer["tm"]["Wr"].shape[2] // cfg.head_dim
    if cfg.mixer == "mla":
        return mixer["wq"].shape[2] // (cfg.mla["qk_nope"] +
                                         cfg.mla["qk_rope"])
    return mixer["wq"].shape[2] // cfg.head_dim


def tp_serve_child(dev, full, tp, new: int, timed_steps: int = 4) -> dict:
    """`full` through `ServeEngine(mesh=tp)` with the kernels on this
    rank's heads, d_ff and vocabulary, N_REQ requests of `new` tokens:
    each kernel's launches in `serve` (counts at 0 just before) equal to
    `zoo.kernel_launches(full, tp)`'s count, each kernel variant of
    TP_ROUTES on the local heads (the scans' `_tiled`, flash and decode
    attention's `_mma` and `_split` on the local heads and the KV-head
    range of the cache), a timed prefill and `timed_steps` decode steps
    after a warm-up wave (with `timed_steps` 0, none: the profiled
    passes' walls stand for them), the tokens."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import transformer as tfm
    from repro_torch.models import zoo
    from repro_torch.models.module import tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine
    counters = {"rmsnorm": rmsnorm_fwd, "flash_attention": flash_attention_fwd,
                "decode_attention": decode_attention_fwd,
                "ssd_scan": ssd_scan, "rwkv6_scan": rwkv6_scan,
                "moe_gemm": moe_gemm}
    eng = in_turn(lambda: ServeEngine(
        full, seeded_params(full, dev), mesh=tp, batch_slots=SLOTS,
        prompt_len=PROMPT, max_len=MAX_LEN, device=dev))
    assert eng.kernels
    sh = tfm.param_shardings(full, tp)
    split = sorted(tfm.split_blocks(full, tfm.layer_shardings(sh["layers"])))
    local_heads = tp_local_heads(full, eng.params["layers"]["mixer"])
    prompts = np.random.default_rng(5).integers(1, full.vocab,
                                                size=(N_REQ, PROMPT))

    def requests(n=new):
        return [Request(prompt=p, max_new_tokens=n) for p in prompts]

    if timed_steps:
        eng.run(requests(2)[:SLOTS])           # warm-up
    for fn in counters.values():
        fn.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    reqs = eng.serve(requests())
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    per_prefill, per_step = zoo.kernel_launches(full, tp)
    expected = {k: WAVES * per_prefill.get(k, 0)
                + WAVES * (new - 1) * per_step.get(k, 0) for k in counters}
    assert launches == expected, (launches, expected)
    assert all(r.done and len(r.out_tokens) == new and
               all(0 <= t < full.vocab for t in r.out_tokens) for r in reqs)
    if timed_steps:
        sync(dev)
        t0 = time.perf_counter()
        tok = eng.prefill_step(requests()[:SLOTS])
        tok.tolist()
        t1 = time.perf_counter()
        for _ in range(timed_steps):
            tok = eng.decode_once(tok)
            tok.tolist()
        t2 = time.perf_counter()
        prefill_ms = (t1 - t0) * 1e3
        decode_ms = (t2 - t1) * 1e3 / timed_steps
    pre, pre_k = step_profile(
        lambda: eng.prefill_step(requests()[:SLOTS]).tolist())
    tok = eng.decode_once(eng.prefill_step(requests()[:SLOTS]))
    step, step_k = step_profile(lambda: eng.decode_once(tok).tolist())
    if not timed_steps:
        prefill_ms, decode_ms = pre["wall_ms"], step["wall_ms"]
    if "mixer" in split:    # each scan and attention kernel ran on these
        heads = full.d_model // full.head_dim if full.mixer == "rwkv6" \
            else full.n_heads
        if full.mixer == "mamba2":
            heads = full.ssm.get("expand", 2) * full.d_model // \
                full.ssm["headdim"]
        assert local_heads * tp.size("model") == heads, (local_heads, heads)
    variants = {}
    for kernel, suffix, where in TP_ROUTES[full.name]:
        assert_variant(pre_k if where == "prefill" else step_k, kernel,
                       suffix)
        variants[f"{kernel} ({where})"] = suffix
    out = {"arch": full.name, "n_layers": full.n_layers, "mesh": list(TP_MESH),
           "split": split, "local_heads": local_heads,
           "requests": N_REQ, "new_tokens": new,
           "wall_s": wall, "tokens_per_s": N_REQ * new / wall,
           "launches": launches, "expected_launches": expected,
           "variants": variants,
           "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
           "prefill_profile": pre,
           "decode_step_profile": step,
           "local_params": sum(x.numel() for x in
                               tree_leaves(eng.params)),
           "tokens": [r.out_tokens for r in reqs]}
    del eng
    torch.cuda.empty_cache()
    return out


def tp_grad_gate(dev, gate, tp, batch: int, seq: int) -> dict:
    """A float32 train loss and its gradients of `gate` on `tp` (this
    rank's blocks) against the mesh-free step on the same rank, at
    `batch` x `seq`: the loss within TP_TRAIN_TOL and every gradient
    block within TP_GRAD_TOL of its leaf's largest magnitude."""
    import torch
    from repro_torch.models import zoo
    from repro_torch.models.module import tree_leaves, tree_unflatten
    from repro_torch.models.transformer import param_shardings
    from repro_torch.sharding.rules import shard_tree
    params = seeded_params(gate, dev, 4)
    data = token_batch(gate, 0, batch, seq, dev)
    sh = param_shardings(gate, tp)

    def loss_grads(p, mesh):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        loss = zoo.train_loss(gate, tree_unflatten(p, leaves), data,
                              mesh=mesh)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    want_loss, want = loss_grads(params, None)
    loss, grads = loss_grads(shard_tree(params, sh), tp)
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    worst = 0.0
    for g, w, s in zip(grads, want, tree_leaves(sh)):
        worst = max(worst, float((g - s.shard(w)).abs().max()) /
                    max(float(w.abs().max()), 1e-30))
    assert loss_rel <= TP_TRAIN_TOL, (gate.name, loss, want_loss)
    assert worst <= TP_GRAD_TOL, (gate.name, worst)
    del params, grads, want
    torch.cuda.empty_cache()
    return {"n_layers": gate.n_layers, "batch": batch, "seq": seq,
            "loss": loss, "loss_rel_diff": loss_rel,
            "grad_rel_diff": worst, "tol": [TP_TRAIN_TOL, TP_GRAD_TOL]}


def tp_mixer_child(dev, arch: str, cfg, tp, use: bool) -> dict:
    """One mixer model of TP_MIXERS on the two ranks: its serving with
    the kernels (`tp_serve_child`, on the card), its float32 gate's
    logits at TP_MIXER_DEPTH (the ranks' blocks cut in turn), and for
    TP_MIXER_TRAIN its float32 gradients (`tp_grad_gate`)."""
    import dataclasses

    import torch
    from repro_torch.models.transformer import param_shardings
    from repro_torch.sharding.rules import shard_tree
    t0 = time.perf_counter()
    out = {}
    if use:
        out["serve"] = tp_serve_child(dev, cfg, tp, TP_MIXER_NEW, 0)
    out["serve_s"] = time.perf_counter() - t0
    gate = dataclasses.replace(cut(cfg, TP_MIXER_DEPTH[arch]),
                               dtype=torch.float32)
    local = in_turn(lambda: shard_tree(seeded_params(gate, dev, 1),
                                       param_shardings(gate, tp)))
    logits, _ = kv_decode(gate, local, tp, dev, False, kernels=None,
                          sharded=True)
    out["gate"] = [x.cpu().numpy() for x in logits]
    del local, logits
    if arch in TP_MIXER_TRAIN:
        out["train"] = tp_grad_gate(dev, gate, tp, **TP_MIXER_SHAPE)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def tp_train_child(dev, full, gate, tp) -> dict:
    """`tp_grad_gate` of `gate` at PIPE's batch and seq; then
    `make_train_step(full, tp)` in bf16 at full width and depth at PIPE's
    batch and seq, timed."""
    import torch
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.transformer import param_shardings
    from repro_torch.sharding.rules import shard_tree
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)
    f32 = tp_grad_gate(dev, gate, tp, PIPE["batch"], PIPE["seq"])
    p = shard_tree(seeded_params(full, dev, 4), param_shardings(full, tp))
    torch.cuda.empty_cache()
    scfg = TrainStepConfig(remat=True, opt=AdamWConfig())
    state = init_train_state(full, p, scfg)
    step = make_train_step(full, tp, scfg)
    batch = token_batch(full, 0, PIPE["batch"], PIPE["seq"], dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    p, state, m = step(p, state, batch)             # warm-up
    ms = []
    for _ in range(TP_TIMED):
        sync(dev)
        t0 = time.perf_counter()
        p, state, m = step(p, state, batch)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    assert np.isfinite(float(m["loss"])), m
    out = {"float32": f32,
           "bf16": {"n_layers": full.n_layers, "batch": PIPE["batch"],
                    "seq": PIPE["seq"], "step_ms": ms,
                    "loss": float(m["loss"]),
                    "local_params": sum(x.numel() for x in tree_leaves(p)),
                    "max_memory_allocated":
                    torch.cuda.max_memory_allocated()
                    if dev.type == "cuda" else None}}
    del p, state, step
    torch.cuda.empty_cache()
    return out


def two_rank_child(rank: int, world: int, d: str, device_type: str,
                   full, moe_cfg, gate_layers: int, shapes: dict,
                   mixers: dict) -> None:
    """One of two ranks sharing one device through gloo: a probe of the
    collectives on that device's tensors, then split-KV decode on the
    (2, 1) host mesh and a 2-stage pipeline, each in float32 at
    `gate_layers` layers (logits and losses written for the parent to
    hold) and in bf16 at full width and depth (times), and `moe_cfg`'s
    MoE layer on a (1, 2) mesh: each rank's half of the experts' d_ff
    through `moe_gemm`'s tensor-core kernel."""
    import dataclasses
    import pickle

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import Mesh
    globals().update(shapes)         # the parent's PIPE and serving shapes
    dev = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")
    if device_type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        d, "store"), rank=rank, world_size=world)
    # gloo's collectives on this device's tensors (staged through the host)
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    parts = [torch.empty(2, device=dev) for _ in range(world)]
    dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
    assert float(x[0]) == 3.0 and [float(p[0]) for p in parts] == [0.0, 1.0]
    res = {}
    gate = dataclasses.replace(cut(full, gate_layers),
                               dtype=torch.float32)
    mesh = make_host_mesh(device_type=device_type)
    pipe = Mesh((2, 1), ("pipe", "data"), device_type=device_type)
    logits, _ = kv_decode(gate, seeded_params(gate, dev, 1), mesh, dev,
                          True, kernels=False)
    res["kv_gate"] = [x.cpu().numpy() for x in logits]
    _, res["kv_ms"] = kv_decode(full, seeded_params(full, dev, 1), mesh,
                                dev, True, steps=1, kernels=False)
    shape = dict(batch=PIPE["batch"], seq=PIPE["seq"],
                 microbatches=PIPE["microbatches"])
    loss, grads, _ = pipeline_run(gate, seeded_params(gate, dev, 4),
                                  pipe, dev, **shape)
    res["pipe_gate"] = {"loss": loss, "stage": pipe.index("pipe"),
                        "grads": [g.cpu().numpy() for g in grads]}
    params = seeded_params(full, dev, 4)
    pipeline_run(full, params, pipe, dev, **dict(shape, seq=128))
    loss, _, ms = pipeline_run(full, params, pipe, dev, **shape)
    res["pipe_full"] = {"loss": loss, "ms": ms}
    del params
    # the expert-parallel MoE: d_ff split over two "model" ranks
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.models.layers import moe_ffn
    tp = Mesh((1, 2), ("data", "model"), device_type=device_type)
    params, x, kw = moe_inputs(moe_cfg, dev)
    use = device_type == "cuda"
    moe_gemm.launches = 0
    y, _ = moe_ffn(params, x, mesh=tp, kernels=use, **kw)
    res["moe"] = {"out": y.float().cpu().numpy(),
                  "launches": moe_gemm.launches,
                  "d_ff_local": moe_cfg.moe["d_ff_expert"] // 2}
    if use:
        _, kernels = step_profile(
            lambda: moe_ffn(params, x, mesh=tp, kernels=True, **kw))
        assert_variant(kernels, "moe_gemm_kernel", "_mma")
        res["moe"]["variant"] = "_mma"
    del params, x
    # tensor-parallel dense layers: heads, d_ff and vocabulary over "model"
    if use:
        torch.cuda.empty_cache()
        res["tp_serve"] = tp_serve_child(dev, full, tp, SERVED[full.name][0])
    logits, _ = kv_decode(gate, seeded_params(gate, dev, 1), tp, dev,
                          False, kernels=None)
    res["tp_gate"] = [x.cpu().numpy() for x in logits]
    res["tp_train"] = tp_train_child(dev, full, gate, tp)
    # the mixers tensor-parallel: Mamba2, RWKV6 and MLA on local heads
    res["tp_mixers"] = {a: tp_mixer_child(dev, a, cfg, tp, use)
                        for a, cfg in mixers.items()}
    if device_type == "cuda":
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    dist.destroy_process_group()
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def two_ranks(dev, full, moe_cfg, gate_layers: int, one: dict,
              mixers: dict) -> dict:
    """Two ranks sharing the one device: two processes through gloo
    (NCCL refuses two ranks on one device; gloo stages CUDA tensors
    through host memory).  Each rank's split-KV decode and 2-stage
    pipeline are held against the one-rank results of `one` in float32
    at `gate_layers` layers (logits F32_LOGITS_TOL; the loss 1e-5
    relative and every gradient 1e-4 of its leaf's largest magnitude),
    and timed in bf16 at full width and depth."""
    import pickle

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        shapes = {"PIPE": PIPE, "SLOTS": SLOTS, "PROMPT": PROMPT,
                  "MAX_LEN": MAX_LEN, "TP_MIXER_DEPTH": TP_MIXER_DEPTH,
                  "TP_MIXER_SHAPE": TP_MIXER_SHAPE}
        mp.start_processes(two_rank_child, args=(
            2, d, dev.type, full, moe_cfg, gate_layers, shapes, mixers),
            nprocs=2,
            join=True,
            start_method="spawn")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    out = {"backend": "gloo", "world_size": 2, "wall_s": wall,
           "transport": "host memory (gloo stages device tensors through "
                        "the host; not an NVLink system's times)",
           "shared": True}
    kv = [max(float(np.abs(a - b.cpu().numpy()).max())
              for a, b in zip(r["kv_gate"], one["kv"])) for r in ranks]
    assert max(kv) <= F32_LOGITS_TOL, kv
    want_loss, want_grads = one["pipe"]
    worst = 0.0
    for r in ranks:
        g = r["pipe_gate"]
        assert abs(g["loss"] - want_loss) <= 1e-5 * abs(want_loss), \
            (g["loss"], want_loss)
        for got, w in zip(g["grads"], want_grads):
            w = w.cpu().numpy()
            if got.shape != w.shape:     # a layer leaf: this stage's half
                w = w.reshape((2, -1) + w.shape[2:])[g["stage"]:
                                                     g["stage"] + 1]
            worst = max(worst, float(np.abs(got - w).max()) /
                        max(float(np.abs(w).max()), 1e-30))
    assert worst <= 1e-4, worst
    assert abs(ranks[0]["pipe_full"]["loss"] -
               ranks[1]["pipe_full"]["loss"]) == 0.0
    want = one["moe"].float().cpu().numpy()
    limit = SERVE_TOL["bfloat16"] * max(1.0, float(np.abs(want).max()))
    moe_err = max(float(np.abs(r["moe"]["out"] - want).max()) for r in ranks)
    assert moe_err <= limit, (moe_err, limit)
    assert all(r["moe"]["launches"] == (3 if dev.type == "cuda" else 0)
               for r in ranks)
    tp_gate = [max(float(np.abs(a - b.cpu().numpy()).max())
                   for a, b in zip(r["tp_gate"], one["tp_gate"]))
               for r in ranks]
    assert max(tp_gate) <= F32_LOGITS_TOL, tp_gate
    tp = {"mesh": list(TP_MESH), "gate_max_abs_diff": max(tp_gate),
          "gate_tol": F32_LOGITS_TOL,
          "train": [r["tp_train"] for r in ranks], "mixers": {}}
    for arch in mixers:
        got = [r["tp_mixers"][arch] for r in ranks]
        diffs = [max(float(np.abs(a - b.cpu().numpy()).max())
                     for a, b in zip(g["gate"], one["tp_mixers"][arch]))
                 for g in got]
        assert max(diffs) <= F32_LOGITS_TOL, (arch, diffs)
        line = {"wall_s": [g["wall_s"] for g in got],
                "serve_s": [g["serve_s"] for g in got],
                "gate_n_layers": TP_MIXER_DEPTH[arch],
                "gate_max_abs_diff": max(diffs),
                "gate_logits_max_abs": float(np.abs(got[0]["gate"][0]).max())}
        if arch in TP_MIXER_TRAIN:
            line["train_float32"] = [g["train"] for g in got]
        if dev.type == "cuda":
            assert got[0]["serve"]["tokens"] == got[1]["serve"]["tokens"]
            line["serve"] = [{k: v for k, v in g["serve"].items()
                              if k != "tokens"} for g in got]
        tp["mixers"][arch] = line
    if dev.type == "cuda":
        serve = [r["tp_serve"] for r in ranks]
        # both ranks sample from the same whole logits
        assert serve[0]["tokens"] == serve[1]["tokens"]
        same = [a == b for x, y in zip(serve[0]["tokens"], one["tokens"])
                for a, b in zip(x, y)]
        tp["serve"] = [{k: v for k, v in r.items() if k != "tokens"}
                       for r in serve]
        tp["serve_token_agreement_with_one_rank"] = sum(same) / len(same)
    out.update({"tensor_parallel": tp,
        "kv_gate_max_abs_diff": max(kv), "kv_decode_ms_per_step":
        [r["kv_ms"] for r in ranks], "pipe_gate_grad_rel_diff": worst,
        "pipe_full_loss": ranks[0]["pipe_full"]["loss"],
        "pipe_full_ms": [r["pipe_full"]["ms"] for r in ranks],
        "moe": {"mesh": [1, 2], "d_ff_local": ranks[0]["moe"]["d_ff_local"],
                "max_abs_err_vs_one_rank": moe_err,
                "launches": [r["moe"]["launches"] for r in ranks],
                "variant": ranks[0]["moe"].get("variant")},
        "max_memory_allocated": [r.get("max_memory_allocated")
                                 for r in ranks]})
    return out


def mesh_phase(dev, counters, *, serve_cfg, moe_cfg, mixers: dict,
               gate_layers: int = 2) -> dict:
    """The multi-device layer on one device: a one-rank process group
    (NCCL on the card) under `make_host_mesh()`; the serving engine, the
    split-KV decode, the expert-parallel MoE and the pipeline at one
    stage on it; the production mesh's refusal; then two ranks on the one
    device (`two_ranks`), held against this rank's results; `mixers`:
    {name: config} of TP_MIXERS (their float32 gates here at
    TP_MIXER_DEPTH)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models.module import tree_leaves
    from repro_torch.sharding.rules import Mesh

    backend = "nccl" if dev.type == "cuda" else "gloo"
    out = {"phase": "mesh"}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(backend, init_method="file://" +
                                os.path.join(d, "store"), rank=0,
                                world_size=1)
        try:
            mesh = make_host_mesh(device_type=dev.type)
            assert mesh.shape == {"data": 1, "model": 1}
            assert mesh.device_mesh is not None
            out.update(backend=dist.get_backend(),
                       world_size=dist.get_world_size(), mesh=mesh.shape)
            out["serve"] = mesh_serve(dev, counters, mesh, serve_cfg)
            out["kv_seq_shard"] = mesh_kv(dev, mesh, serve_cfg)
            out["moe"], moe_out = mesh_moe(dev, counters, mesh, moe_cfg)
            out["pipeline"] = mesh_pipeline(dev, serve_cfg,
                                            cut(serve_cfg, gate_layers))
            try:
                make_production_mesh(device_type=dev.type)
                raise AssertionError("the production mesh took one rank")
            except ValueError as e:
                out["production_mesh"] = str(e)
            # this rank's float32 results at the gate's depth
            gate = dataclasses.replace(cut(serve_cfg, gate_layers),
                                       dtype=torch.float32)
            kv, _ = kv_decode(gate, seeded_params(gate, dev, 1), mesh, dev,
                              True, kernels=False)
            tp_gate, _ = kv_decode(gate, seeded_params(gate, dev, 1), mesh,
                                   dev, False, kernels=None)
            mixer_gates = {}
            for arch, cfg in mixers.items():
                g = dataclasses.replace(cut(cfg, TP_MIXER_DEPTH[arch]),
                                        dtype=torch.float32)
                mixer_gates[arch], _ = kv_decode(
                    g, seeded_params(g, dev, 1), mesh, dev, False,
                    kernels=None)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            pipe1 = Mesh((1, 1), ("pipe", "data"), device_type=dev.type)
            params = seeded_params(gate, dev, 4)
            loss, grads, _ = pipeline_run(
                gate, params, pipe1, dev, batch=PIPE["batch"],
                seq=PIPE["seq"], microbatches=PIPE["microbatches"])
            assert len(grads) == len(tree_leaves(params))
            one = {"kv": kv, "pipe": (loss, grads), "moe": moe_out,
                   "tp_gate": tp_gate, "tp_mixers": mixer_gates,
                   "tokens": out["serve"].pop("tokens")}
            del params, grads
        finally:
            dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["one_rank_wall_s"] = time.perf_counter() - t0
    out["two_ranks"] = two_ranks(dev, serve_cfg, moe_cfg, gate_layers, one,
                                 mixers)
    out["wall_s"] = time.perf_counter() - t0
    return out


def train_step_fn(cfg, steps: int = 8, opt: dict | None = None, **kw):
    """A train step with the configuration `launch.train` builds for
    `steps` steps at its default learning rate, or with the AdamW fields
    `opt`; `kw` sets the rest."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig, make_train_step
    opt = opt or dict(total_steps=steps, warmup_steps=min(20, steps // 5))
    return make_train_step(cfg, None,
                           TrainStepConfig(opt=AdamWConfig(**opt), **kw))


def train_state(cfg, params, steps: int = 8, **kw):
    """`train_step_fn` and a fresh optimizer state for `params`."""
    from repro_torch.train.train_step import TrainStepConfig, init_train_state
    return train_step_fn(cfg, steps, **kw), init_train_state(
        cfg, params, TrainStepConfig(**kw))


def token_batch(cfg, step: int, batch: int, seq: int, dev) -> dict:
    """TokenStream's synthetic batch of `step` on the device."""
    import torch
    from repro_torch.train.data import DataConfig, TokenStream
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch))
    return {k: torch.from_numpy(v).to(dev)
            for k, v in data.global_batch(step).items()}


def op_profile(fn, top: int = 12) -> list:
    """`fn` under the profiler: the aten ops that launched the most device
    time (self device ms and calls), largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.key.startswith("aten::")
            and getattr(ev, "self_device_time_total", 0) > 0]
    rows.sort(reverse=True)
    return [{"op": k, "device_ms": us / 1e3, "calls": c}
            for us, k, c in rows[:top]]


def rel_diff(got, want) -> float:
    """Largest difference relative to the largest magnitude of `want`."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def train_rel_diff(a, b, lr: float, b1: float = 0.9,
                   eps: float = 1e-8) -> dict:
    """Two first-step (params, state, metrics) results against each other:
    loss, grad norm and lr, m and v relative to each tensor's largest
    magnitude, and the parameters beyond what their m already explains.
    A first AdamW step moves a parameter by lr (u + wd p) with u = h /
    (|h| + eps), h = m / (1 - b1) the clipped gradient: a near-zero h can
    turn u over (float32 sums in another order), so the parameters are
    held to lr |u_a - u_b| (from the held m) plus a tolerance relative to
    their largest magnitude; `params` is that excess."""
    from repro_torch.models.module import tree_leaves
    (pa, sa, ma), (pb, sb, mb) = a, b
    out = {k: rel_diff(ma[k], mb[k]) for k in ("loss", "grad_norm", "lr")}
    for name in ("m", "v"):
        out[name] = max(rel_diff(u, w) for u, w in
                        zip(tree_leaves(sa[name]), tree_leaves(sb[name])))
    excess, raw = 0.0, 0.0
    for x, y, m_a, m_b in zip(tree_leaves(pa), tree_leaves(pb),
                              tree_leaves(sa["m"]), tree_leaves(sb["m"])):
        h_a, h_b = m_a.cpu() / (1 - b1), m_b.cpu() / (1 - b1)
        turn = (h_a / (h_a.abs() + eps) - h_b / (h_b.abs() + eps)).abs()
        diff = (x.float().cpu() - y.float().cpu()).abs()
        top = float(y.abs().max())
        raw = max(raw, float(diff.max()) / top)
        excess = max(excess, float((diff - lr * turn).max()) / top)
    out["params"] = excess
    out["params_raw"] = raw
    return out


def train_gate(diffs: dict, tol: float) -> None:
    assert max(v for k, v in diffs.items() if k != "params_raw") <= tol, \
        (diffs, tol)


def train_float32_gate(dev) -> dict:
    """llama3.2-3b at full width and TRAIN_F32["depth"] layers in float32,
    TF32 off: one train step on the card against the same port code on the
    CPU, then microbatches 2 against 1 and remat against none on the card
    (`train_rel_diff`); the weights are made once on the CPU from seed
    0."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import zoo
    from repro_torch.models.module import init_from_specs, tree_map
    g = TRAIN_F32
    cfg = dataclasses.replace(cut(ARCHS[TRAIN_ARCH], g["depth"]),
                              dtype=torch.float32)
    host = init_from_specs(zoo.build_param_specs(cfg), 0, device="cpu")
    batch = token_batch(cfg, 0, 2 * g["batch"], g["seq"], "cpu")
    one = {k: v[:g["batch"]] for k, v in batch.items()}

    def step(device, data, **kw):
        params = tree_map(lambda p: p.to(device, copy=True), host)
        fn, state = train_state(cfg, params, **kw)
        t0 = time.perf_counter()
        out = fn(params, state, {k: v.to(device) for k, v in data.items()})
        if device != "cpu":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card, card_s = step(dev, one)
        lr = float(card[2]["lr"])
        cpu, cpu_s = step("cpu", one)
        vs_cpu = train_rel_diff(card, cpu, lr)
        del cpu
        whole, _ = step(dev, batch)
        halves, _ = step(dev, batch, microbatches=2)
        vs_mb = train_rel_diff(halves, whole, lr)
        del halves
        plain, _ = step(dev, batch, remat=False)
        vs_remat = train_rel_diff(whole, plain, lr)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    train_gate(vs_cpu, g["cpu_tol"])
    train_gate(vs_mb, g["microbatch_tol"])
    train_gate(vs_remat, g["remat_tol"])
    res = {"phase": "train_float32", "arch": TRAIN_ARCH, **depth_line(cfg),
           "dtype": "float32", "allow_tf32": False,
           "batch": g["batch"], "seq": g["seq"],
           "loss": float(card[2]["loss"]), "card_step_s": card_s,
           "cpu_step_s": cpu_s, "card_vs_cpu": vs_cpu,
           "microbatches_2_vs_1": vs_mb, "remat_vs_none": vs_remat,
           "tol": {k: v for k, v in g.items() if k.endswith("tol")}}
    res["checkpoint"] = train_checkpoints(card)
    del card, whole, plain
    torch.cuda.empty_cache()
    return res


def train_checkpoints(result) -> dict | str:
    """A blocking and an asynchronous save of the depth-2 state, each
    restored onto the card bit-equal; without the optional zstandard, the
    reason it did not run."""
    import torch
    from repro_torch.models.module import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    if ckpt.zstandard is None:
        return "not run: no zstandard"
    params, state, _ = result
    tree = {"params": params, "opt": state}
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for mode, blocking in (("blocking", True), ("async", False)):
            t0 = time.perf_counter()
            ckpt.save(d, 1 if blocking else 2, tree, blocking=blocking)
            returned = time.perf_counter() - t0
            ckpt.wait_for_async()
            saved = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = ckpt.restore(d, 1 if blocking else 2, like_tree=tree)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(back), tree_leaves(tree))), mode
            out[mode] = {"returned_s": returned, "saved_s": saved,
                         "restore_s": time.perf_counter() - t0}
            del back
    return out


def train_phase(dev, counters) -> dict:
    """llama3.2-3b training at full width and depth: the main path through
    `launch.train.main` with every launch count set to 0 just before it
    (the training path runs the plain layers: every count must stay 0),
    then timed steps, one profiled step, the learning gate on a repeated
    batch and one compressed step."""
    import contextlib
    import io
    import re

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train
    from repro_torch.models import zoo
    from repro_torch.models.module import tree_leaves, tree_map
    cfg = ARCHS[TRAIN_ARCH]

    # ---- the main path: the CLI entry point, 8 steps -------------------
    log = io.StringIO()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        params = train.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    assert launches == dict.fromkeys(counters, 0), launches
    main_peak = torch.cuda.max_memory_allocated()
    lines = log.getvalue().splitlines()
    logged = [re.match(r"step +(\d+)  loss (\S+)  gnorm (\S+)  lr (\S+)",
                       ln) for ln in lines]
    logged = [tuple(float(x) for x in m.groups()) for m in logged if m]
    assert lines[-1] == "done" and [int(r[0]) for r in logged] == [0, 7]
    assert all(np.isfinite(r[1:]).all() for r in logged), logged
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))

    # ---- timed steps, then one under the profiler ----------------------
    fn, state = train_state(cfg, params)
    batches = [token_batch(cfg, 100 + i, TRAIN_B, TRAIN_S, dev)
               for i in range(TRAIN_TIMED)]
    torch.cuda.reset_peak_memory_stats()
    events = []
    for b in batches:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        params, state, m = fn(params, state, b)
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in events]
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(step_ms[1:]))
    shape = ShapeConfig(f"train_b{TRAIN_B}_s{TRAIN_S}", "train", TRAIN_S,
                        TRAIN_B)
    flops = zoo.model_flops(cfg, shape)
    tokens = TRAIN_B * TRAIN_S
    # full remat runs every layer's forward twice: + 2 N_layers D + the
    # attention forward again
    n_layers_params = zoo.active_params(cfg) - cfg.vocab * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    executed = flops + 2.0 * n_layers_params * tokens + \
        2.0 * TRAIN_B * TRAIN_S * TRAIN_S * cfg.n_heads * cfg.head_dim
    last = {}

    def one_step():
        nonlocal params, state
        params, state, last["m"] = fn(params, state, batches[0])

    profile, _ = step_profile(one_step)
    ops = op_profile(one_step)
    loss_after = float(last["m"]["loss"])
    del fn, batches, last
    torch.cuda.empty_cache()

    # ---- the learning gate: one batch, LEARN_STEPS steps ---------------
    constant = dict(lr=LEARN_LR, warmup_steps=0, min_lr_ratio=1.0)
    fn = train_step_fn(cfg, opt=constant)
    batch = token_batch(cfg, 1000, TRAIN_B, TRAIN_S, dev)
    losses, gnorms = [], []
    state_step = int(state["step"]) + 1
    for _ in range(LEARN_STEPS):
        params, state, m = fn(params, state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    assert np.isfinite(losses).all() and np.isfinite(gnorms).all()
    assert losses[-1] <= losses[0] - LEARN_DROP, losses

    # ---- one step with int8 gradient compression, from the same state --
    fn = train_step_fn(cfg, opt=constant, grad_compress=True)
    state["ef"] = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=dev), params)
    small = {k: v[:2] for k, v in batch.items()}
    params, state, m = fn(params, state, small)
    ef_finite = all(bool(torch.isfinite(t).all())
                    for t in tree_leaves(state["ef"]))
    ef_max = max(float(t.abs().max()) for t in tree_leaves(state["ef"]))
    assert ef_finite and np.isfinite(float(m["loss"]))
    compressed = {"batch": 2, "seq": TRAIN_S, "loss": float(m["loss"]),
                  "grad_norm": float(m["grad_norm"]), "ef_finite": ef_finite,
                  "ef_max_abs": ef_max}
    del fn, state, params, m, batch, small
    torch.cuda.empty_cache()

    return {
        "phase": "train", "arch": TRAIN_ARCH, **depth_line(cfg),
        "dtype": "bfloat16", "remat": True, "batch": TRAIN_B,
        "seq": TRAIN_S, "argv": TRAIN_ARGV, "main_s": main_s,
        "main_max_memory_allocated": main_peak, "log": lines,
        "launches": launches,
        "step_ms": step_ms, "step_ms_median": med,
        "tokens_per_s": tokens / med * 1e3,
        "model_flops": flops, "executed_flops_estimate": executed,
        "mfu": flops / (med / 1e3) / BF16_OPS_PER_S,
        "max_memory_allocated": peak,
        "profile": {**profile, "loss": loss_after, "top_ops": ops},
        "learning": {"steps": LEARN_STEPS, "lr": LEARN_LR,
                     "first_step": state_step, "losses": losses,
                     "grad_norms": gnorms, "drop": losses[0] - losses[-1],
                     "required_drop": LEARN_DROP},
        "grad_compress": compressed}


@contextlib.contextmanager
def registered(registry: dict, entries: dict):
    """`registry` with `entries` added or replaced inside the block, as it
    was after it."""
    saved = {k: registry[k] for k in entries if k in registry}
    registry.update(entries)
    try:
        yield
    finally:
        for k in entries:
            registry.pop(k, None)
        registry.update(saved)


def dry_cut(cfg):
    """`cfg` at the dryrun phase's production-mesh depth (DRY_DEPTH)."""
    import dataclasses
    over = {"n_layers": DRY_DEPTH.get(cfg.name, 1)}
    if cfg.enc:
        over["enc"] = dict(cfg.enc, enc_layers=1)
    return dataclasses.replace(cfg, **over)


def dry_cell_line(report: dict, seconds: float) -> dict:
    if report.get("skipped"):
        return {"status": "SKIP", "seconds": seconds, "why": report["why"]}
    r, m = report["roofline"], report["memory"]
    return {"status": "OK", "seconds": seconds,
            **{k: r[k] for k in ("t_compute_s", "t_memory_s",
                                 "t_collective_s", "bottleneck",
                                 "useful_flops_ratio", "mfu", "flops",
                                 "xla_flops", "hbm_bytes",
                                 "collective_breakdown")},
            "argument_size_bytes": m["argument_size_bytes"],
            "temp_size_bytes": m["temp_size_bytes"]}


def dryrun_phase(dev, counters) -> dict:
    """The dry run (`repro_torch.launch.dryrun`: fake tensors, an abstract
    mesh, the H100 roofline) held against the card, then run over the
    production meshes (DRY_* above), with every launch count set to 0 just
    before it: fake tensors launch nothing, and the card's steps here run
    the plain layers, so every count must still be 0 after it."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import zoo
    from repro_torch.models.module import init_from_specs
    from repro_torch.sharding.rules import Mesh
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)
    for fn in counters.values():
        fn.launches = 0
    t_phase = time.perf_counter()
    cfg = ARCHS[TRAIN_ARCH]
    one = Mesh.abstract((1, 1), ("data", "model"), device_type="cuda")
    train_shape = ShapeConfig(f"train_b{TRAIN_B}_s{TRAIN_S}", "train",
                              TRAIN_S, TRAIN_B)
    dec_shape = ShapeConfig(f"decode_b{SLOTS}_s{MAX_LEN}", "decode",
                            MAX_LEN, SLOTS)
    with registered(SHAPES, {s.name: s for s in (train_shape, dec_shape)}):
        t0 = time.perf_counter()
        _, dry = dryrun.lower_cell(TRAIN_ARCH, train_shape.name,
                                   multi_pod=False, mesh=one, device="cuda")
        dry_s = time.perf_counter() - t0
        _, dry_dec = dryrun.lower_cell(TRAIN_ARCH, dec_shape.name,
                                       multi_pod=False, mesh=one,
                                       device="cuda")
    roof, mem = dry["roofline"], dry["memory"]

    # ---- the same step on the card ---------------------------------------
    step_cfg = TrainStepConfig(remat=True, opt=AdamWConfig())
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = init_from_specs(zoo.build_param_specs(cfg), 0, device=dev)
    state = init_train_state(cfg, params, step_cfg)
    batch = token_batch(cfg, 0, TRAIN_B, TRAIN_S, dev)
    torch.cuda.synchronize()
    args_alloc = torch.cuda.memory_allocated() - base
    fn = make_train_step(cfg, one, step_cfg)
    counter = FlopCounterMode(display=False)
    with counter:
        params, state, m = fn(params, state, batch)
    torch.cuda.synchronize()
    card_flops = counter.get_total_flops()
    assert np.isfinite(float(m["loss"]))
    torch.cuda.reset_peak_memory_stats()
    events = []
    for _ in range(DRY_TIMED):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        params, state, m = fn(params, state, batch)
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    step_ms = [a.elapsed_time(b) for a, b in events]
    med_s = float(np.median(step_ms)) / 1e3
    del fn, state, batch, m
    torch.cuda.empty_cache()

    # ---- one decode step of 4 slots, the plain layers ---------------------
    caches = init_from_specs(zoo.build_cache_specs(cfg, SLOTS, MAX_LEN), 0,
                             device=dev)
    tokens = torch.ones((SLOTS, 1), dtype=torch.int32, device=dev)

    def decode():
        return zoo.decode_step(cfg, params, tokens, caches, MAX_LEN - 1,
                               mesh=one, kernels=False)

    for _ in range(2):
        decode()
    dec_ms = cuda_ms(decode, iters=DRY_DECODE_STEPS, warmup=0)
    del params, caches, tokens
    torch.cuda.empty_cache()
    predicted = {"flops": roof["flops"], "card_flops": card_flops,
                 "flops_ratio": roof["flops"] / card_flops,
                 "xla_flops": roof["xla_flops"],
                 "argument_size_bytes": mem["argument_size_bytes"],
                 "card_argument_bytes": args_alloc,
                 "argument_ratio": mem["argument_size_bytes"] / args_alloc,
                 "temp_size_bytes": mem["temp_size_bytes"],
                 "card_peak_bytes": peak,
                 "peak_ratio": (mem["argument_size_bytes"] +
                                mem["temp_size_bytes"]) / peak,
                 "step_time_s": max(roof["t_compute_s"], roof["t_memory_s"],
                                    roof["t_collective_s"]),
                 "card_step_ms": step_ms, "card_step_s_median": med_s,
                 "mfu": roof["mfu"],
                 "card_mfu": roof["model_flops"] / med_s / BF16_OPS_PER_S,
                 "bottleneck": roof["bottleneck"],
                 "t_compute_s": roof["t_compute_s"],
                 "t_memory_s": roof["t_memory_s"],
                 "useful_flops_ratio": roof["useful_flops_ratio"],
                 "dry_run_s": dry_s}
    predicted["step_ratio"] = med_s / predicted["step_time_s"]
    for key in ("flops_ratio", "argument_ratio"):
        assert abs(predicted[key] - 1) <= DRY_TOL, (key, predicted)
    dr = dry_dec["roofline"]
    decode_line = {
        "slots": SLOTS, "cache": MAX_LEN, "cur_len": MAX_LEN - 1,
        "t_memory_s": dr["t_memory_s"],
        "t_memory_unfused_s": dr["t_memory_unfused_s"],
        "t_compute_s": dr["t_compute_s"], "hbm_bytes": dr["hbm_bytes"],
        "card_ms": dec_ms,
        "weights_bound_ms": depth_line(cfg)["param_bytes"] /
        HBM_BYTES_PER_S * 1e3,
        "ratio_to_memory_term": dec_ms / 1e3 / dr["t_memory_s"]}

    # ---- the production meshes ------------------------------------------
    cells, failures = {}, []
    grid = [(False, arch, shape) for arch in ARCHS for shape in DRY_SHAPES]
    grid.append((True, TRAIN_ARCH, "train_4k"))
    for multi_pod, arch, shape in grid:
        tag = "2x16x16" if multi_pod else "16x16"
        cell = f"{tag}/{arch}/{shape}"
        t0 = time.perf_counter()
        try:
            with registered(ARCHS, {arch: dry_cut(ARCHS[arch])}):
                _, rep = dryrun.lower_cell(arch, shape, multi_pod=multi_pod,
                                           device="cuda")
            cells[cell] = dry_cell_line(rep, time.perf_counter() - t0)
        except Exception as e:
            failures.append(cell)
            cells[cell] = {"status": "FAIL", "error": repr(e)}
    launches = {name: fn.launches for name, fn in counters.items()}
    seconds = time.perf_counter() - t_phase
    assert not failures, (failures, [cells[c] for c in failures])
    assert launches == dict.fromkeys(counters, 0), launches
    assert seconds <= DRY_BUDGET_S, seconds
    return {"phase": "dryrun", "arch": TRAIN_ARCH, "launches": launches,
            "seconds": seconds, "budget_s": DRY_BUDGET_S, "tol": DRY_TOL,
            "train": predicted, "decode": decode_line,
            "production": {"depth": {a: dry_cut(c).n_layers
                                     for a, c in ARCHS.items()},
                           "shapes": list(DRY_SHAPES), "cells": cells}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.analysis.staticcheck import racecheck
    from repro_torch.api.session import default_session
    from repro_torch.configs.paper_workloads import resnet18, squeezenet
    from repro_torch.core import explore
    from repro_torch.hw.catalog import mc_hetero, mc_hom_tpu_chip4
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.kernels.ref import serialize_prefix_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.wavefront import (serialize_prefix,
                                               wavefront_scan)

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
               "moe_gemm": check_moe_gemm(dev)}
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

    # ---- batched fitness on the card, both routes -------------------------
    session = default_session()
    fitness = [fitness_phase(dev, session, w, acc)
               for w, acc in ((resnet18(), mc_hetero()),
                              (squeezenet(), mc_hom_tpu_chip4()))]
    for line in fitness:
        emit(line)

    # ---- the main path: explore(prefilter=True) on the card ---------------
    w, acc = resnet18(), mc_hetero()
    kw = dict(granularity=GRAN, pop_size=24, generations=16, seed=0)
    counters = {"wavefront_scan": wavefront_scan,
                "serialize_prefix": serialize_prefix,
                "rmsnorm": rmsnorm_fwd,
                "decode_attention": decode_attention_fwd,
                "flash_attention": flash_attention_fwd,
                "ssd_scan": ssd_scan, "rwkv6_scan": rwkv6_scan,
                "moe_gemm": moe_gemm}
    with counted_chunks() as chunks:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = explore(w, acc, prefilter=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = wavefront_scan.launches
    assert res.ga.prefilter_screened > 0, res.ga
    assert launches == len(chunks) > 0, (launches, len(chunks))
    assert all(fn.launches == 0 for name, fn in counters.items()
               if name != "wavefront_scan")
    chunk_check = hold_chunks_against_plain(chunks, counters)
    del chunks
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
          "prefilter_chunks": chunk_check["chunks"],
          "chunks_vs_plain": chunk_check,
          "serialize_prefix_launches": serialize_prefix.launches,
          "prefilter_screened": res.ga.prefilter_screened,
          "prefilter_pruned": res.ga.prefilter_pruned,
          "evaluations": res.ga.evaluations,
          "unfiltered_evaluations": base.ga.evaluations,
          "latency_cc": res.latency_cc, "energy_pj": res.energy_pj,
          "allocation_equals_unfiltered": bool(
              np.array_equal(res.allocation, base.allocation))})

    # ---- the race detector over the final schedule -----------------------
    # schedule(validate=True) drops the detector's report, as the
    # reference's does: keep it from the one call the schedule makes
    engine = session.engine(w, acc, GRAN)
    validate_trace = racecheck.validate_trace
    reports = []

    def kept(*args, **kwargs):
        reports.append(validate_trace(*args, **kwargs))
        return reports[-1]

    racecheck.validate_trace = kept
    try:
        t0 = time.perf_counter()
        checked = engine.schedule(res.allocation, "latency", validate=True)
        validate_s = time.perf_counter() - t0
    finally:
        racecheck.validate_trace = validate_trace
    assert (checked.latency_cc, checked.energy_pj) == (res.latency_cc,
                                                      res.energy_pj)
    assert len(reports) == 1, reports
    emit({"phase": "validate", "workload": w.name, "arch": acc.name,
          "schedule_validate_s": validate_s, "report": reports[0]})

    # ---- the DSE runtime: the paper's grid, stores, executors, shards ----
    with tempfile.TemporaryDirectory() as work_dir:
        swept, grid_session, grid_space = sweep_phase(counters, work_dir)
        emit(swept)
        dist_line, serial = distributed_phase(work_dir, grid_session,
                                              grid_space, swept["best_fused"])
        emit(dist_line)
        emit(tools_phase(work_dir, serial, counters))
    emit(simulate_phase())

    # ---- the serving main paths: each model through ServeEngine.serve ----
    served = {}
    for arch in SERVED:
        if arch == "qwen2-vl-72b":       # whisper first, in ARCHS' order
            served[WHISPER] = whisper_phase(dev, counters)
            emit(served[WHISPER])
        served[arch] = serve_phase(dev, counters, arch)
        emit(served[arch])

    # ---- the training main path: launch.train at full width and depth --
    trained = train_phase(dev, counters)
    emit(trained)
    emit(train_float32_gate(dev))

    # ---- the dry run against the card, then the production meshes -------
    dried = dryrun_phase(dev, counters)
    emit(dried)

    # ---- the multi-device layer on the card ------------------------------
    from repro_torch.configs import ARCHS
    meshed = mesh_phase(dev, counters, serve_cfg=ARCHS[MESH_ARCH],
                        moe_cfg=ARCHS[MESH_MOE],
                        mixers={a: cut(ARCHS[a], DEPTH.get(a))
                                for a in TP_MIXERS})
    emit(meshed)

    t = times[TIMED_SHAPES[0]]
    sc = fitness[0]["scan"]
    rows = [{
        "name": "wavefront_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wavefront.cu",
        "replaces": "src/repro/kernels/wavefront.py:37",
        "paths": ["fitness", "explore", "sweep"], "launches": launches,
        "launches_by_path": {
            "explore": launches, "sweep": swept["launches"],
            **{f"fitness {f['workload']} x {f['arch']}":
               f["launches"]["fused"]["wavefront_scan"] for f in fitness}},
        "max_abs_err": max(f["scan"]["max_abs_err"] for f in fitness),
        "ms": sc["ms"], "device_ms": sc["device_ms"],
        "plain_ms": sc["plain_ms"], "bound_ms": sc["bound_ms"],
        "bound_by": sc["bound_by"], "library_ms": None,
        "library_device_ms": None, "shape": sc["shape"],
        "old": sc["old"],
        "by_cell": {f"{f['workload']} x {f['arch']}":
                    {k: f["scan"][k] for k in
                     ("device_ms", "ms", "bound_ms", "old")}
                    for f in fitness}}, {
        "name": "serialize_prefix", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wavefront.cu",
        "replaces": "src/repro/kernels/wavefront.py:37",
        "paths": ["fitness step route"],
        "launches": fitness[0]["launches"]["step"]["serialize_prefix"],
        "max_abs_err": max_abs,
        "ms": t["ms"], "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1], "library_ms": None,
        "library_device_ms": None,
        "shape": list(TIMED_SHAPES[0])}]
    # each serving kernel's launches on the main path of its own family
    # (llama3.2-3b for the first three), with every path's count beside and
    # the paths that launched it
    for name, replaces, arch in (
            ("rmsnorm", "src/repro/kernels/rmsnorm.py:20", "llama3.2-3b"),
            ("decode_attention", "src/repro/kernels/decode_attention.py:56",
             "llama3.2-3b"),
            ("flash_attention", "src/repro/kernels/flash_attention.py:69",
             "llama3.2-3b"),
            ("ssd_scan", "src/repro/kernels/ssd_scan.py:60", "zamba2-2.7b"),
            ("rwkv6_scan", "src/repro/kernels/rwkv6_scan.py:58", "rwkv6-3b"),
            ("moe_gemm", "src/repro/kernels/moe_gemm.py:39",
             "deepseek-moe-16b")):
        m = serving[name]["main"]
        by_path = {a: r["launches"][name] for a, r in served.items()}
        by_path[f"train {TRAIN_ARCH}"] = trained["launches"][name]
        by_path[f"mesh {MESH_ARCH}"] = meshed["serve"]["launches"][name]
        by_path["dryrun"] = dried["launches"][name]
        if name == "moe_gemm":
            by_path[f"mesh moe_ffn {MESH_MOE}"] = meshed["moe"]["launches"]
        tp_two = meshed["two_ranks"]["tensor_parallel"]
        by_path[f"mesh tensor-parallel {MESH_ARCH} (rank 0 of 2)"] = \
            tp_two["serve"][0]["launches"].get(name, 0)
        for a, line in tp_two["mixers"].items():
            by_path[f"mesh tensor-parallel {a} (rank 0 of 2)"] = \
                line["serve"][0]["launches"].get(name, 0)
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "paths": [f"{served[a]['phase']} {a}"
                      for a, n in by_path.items() if n and a in served],
            "launches": served[arch]["launches"][name],
            "launches_by_path": by_path,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "device_ms": m["device_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "library_device_ms": m["library_device_ms"],
            "shape": serving[name]["shape"]}
        for extra in ("variant", "max_ulps"):
            if extra in m:
                row[extra] = m[extra]
        if "old" in m:      # the old kernel of a redesigned scan, same run
            row["old"] = {key: m["old"][key] for key in
                          ("ms", "device_ms", "plain_ms", "bound_ms")}
        assert row["launches"] > 0, row
        rows.append(row)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
