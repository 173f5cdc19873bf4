"""Multi-pod dry run of the port: run every (architecture x input shape x
mesh) cell once on fake tensors, as rank 0 of the production mesh, and
record its memory, its counts and its roofline terms (the JAX package's
`repro/launch/dryrun.py`, which lowers and compiles each cell for 512
placeholder host devices).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-v2-236b \\
      --shape train_4k --multi-pod --device cpu

A cell runs rank 0's program through the port's own entry points, with
the plain layers (`kernels=False`, what the reference lowers), under
`torch._subclasses.FakeTensorMode` (shapes and dtypes, no data, no device
work) and an `analysis.hlo.Recorder` over an abstract mesh
(`Mesh.abstract` of `launch.mesh.production_layout`: no 256 ranks),
which answers the collectives with empty tensors and logs their bytes:

  train    `make_train_step(cfg, mesh, step_cfg)` on this rank's blocks of
           the parameters and the AdamW state, the global batch (which
           every rank holds; the step splits its rows)
  prefill  `zoo.prefill` into this rank's cache blocks
  decode   `zoo.decode_step` at cur_len = seq_len - 1, so the whole cache
           is read (the reference traces cur_len)

The report has the reference's keys.  `memory`: `argument_size_bytes` and
`output_size_bytes`, the bytes of the arguments' and the outputs'
storages (each once; the step updates in place, so its outputs are its
arguments), `temp_size_bytes`, the most bytes the run held alive at once
beyond its arguments, and `generated_code_size_bytes` None (nothing is
compiled).  `lower_s` is the fake run's seconds, `compile_s` 0.0.  The
roofline's `xla_flops` is `FlopCounterMode`'s count over the same run,
beside the recorder's.  Cells a config does not support are skipped by
`cfg.supports_shape`.  Entry points run on "cuda" unless `device="cpu"`:
fake tensors of that device, which take the device's branches of the
program (the card's float32-output head product among them).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.analysis.hlo import Recorder, storage_bytes
from repro_torch.analysis.roofline import analyze_run
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core.vectorized import resolve_device
from repro_torch.launch.mesh import production_layout
from repro_torch.models import zoo
from repro_torch.models.module import abstract_from_specs
from repro_torch.sharding.rules import (Mesh, batch_axes, local_specs,
                                        tree_shardings)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainStepConfig, make_train_step,
                                          train_state_specs)


def _cell_program(cfg, shape, mesh, step_cfg, dev):
    """(fn, args) of one cell, made under the caller's FakeTensorMode."""
    B, S = shape.global_batch, shape.seq_len
    pspecs = zoo.build_param_specs(cfg)
    params = abstract_from_specs(
        local_specs(pspecs, tree_shardings(pspecs, mesh)), dev)
    data = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
            for k, v in zoo.input_specs(cfg, shape).items()
            if k not in ("cur_len", "enc_out")}
    if shape.kind == "train":
        sspecs = train_state_specs(pspecs, step_cfg)
        state = abstract_from_specs(
            local_specs(sspecs, tree_shardings(sspecs, mesh)), dev)
        return make_train_step(cfg, mesh, step_cfg), (params, state, data)
    cspecs = zoo.build_cache_specs(cfg, B, S)
    caches = abstract_from_specs(
        local_specs(cspecs, zoo.cache_shardings(cfg, B, S, mesh)), dev)
    if shape.kind == "prefill":
        def prefill(params, batch, caches):
            return zoo.prefill(cfg, params, batch, caches, mesh=mesh,
                               kernels=False)
        return prefill, (params, data, caches)
    enc_out = None
    if cfg.family == "encdec":      # this rank's rows, as encode gives it
        rows = B // mesh.size(batch_axes(mesh, B))
        enc_out = torch.empty((rows, cfg.enc["enc_len"], cfg.d_model),
                              dtype=cfg.dtype, device=dev)

    def serve_step(params, tokens, caches, enc_out=None):
        return zoo.decode_step(cfg, params, tokens, caches, S - 1,
                               mesh=mesh, enc_out=enc_out, kernels=False)
    args = (params, data["tokens"], caches)
    return serve_step, args if enc_out is None else args + (enc_out,)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               step_cfg: TrainStepConfig | None = None, mesh=None,
               device=None):
    """Run one cell on fake tensors; returns (its `Recorder`, the report
    dict), or (None, a skip report)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    ok, why = cfg.supports_shape(shape)
    if not ok:
        return None, dict(arch=arch, shape=shape_name, skipped=True, why=why)

    dev = resolve_device(device)
    mesh = mesh or Mesh.abstract(*production_layout(multi_pod),
                                 device_type=dev.type)
    chips = mesh.devices.size
    step_cfg = step_cfg or TrainStepConfig(remat=True, opt=AdamWConfig())
    rec = Recorder(mesh)
    with FakeTensorMode():
        fn, args = _cell_program(cfg, shape, mesh, step_cfg, dev)
        arg_bytes = rec.exclude(args)
        counter = FlopCounterMode(display=False)
        t0 = time.perf_counter()
        with counter, rec:
            out = fn(*args)
        t_lower = time.perf_counter() - t0
        out_bytes = storage_bytes(out)

    mem_report = {
        "argument_size_bytes": arg_bytes,
        "output_size_bytes": out_bytes,
        "temp_size_bytes": rec.peak_bytes,
        "generated_code_size_bytes": None,
    }
    roof = analyze_run(rec.analysis(), zoo.model_flops(cfg, shape), chips,
                       xla_flops=counter.get_total_flops())
    report = dict(
        arch=arch, shape=shape_name,
        mesh="x".join(map(str, mesh.devices.shape)), multi_pod=multi_pod,
        chips=chips, kind=shape.kind, lower_s=round(t_lower, 2),
        compile_s=0.0, memory=mem_report, roofline=roof.summary(),
        skipped=False,
    )
    return rec, report


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default cuda)")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    device_type = resolve_device(args.device).type

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for multi_pod in meshes:
        mesh = Mesh.abstract(*production_layout(multi_pod),
                             device_type=device_type)
        tag = "2x16x16" if multi_pod else "16x16"
        for arch in archs:
            for shape in shapes:
                cell = f"{tag}/{arch}/{shape}"
                path = os.path.join(args.out, tag, arch)
                os.makedirs(path, exist_ok=True)
                fname = os.path.join(path, f"{shape}.json")
                t0 = time.perf_counter()
                try:
                    rec, report = lower_cell(arch, shape,
                                             multi_pod=multi_pod, mesh=mesh,
                                             device=args.device)
                    del rec
                except Exception as e:
                    report = dict(arch=arch, shape=shape, mesh=tag,
                                  failed=True, error=str(e),
                                  traceback=traceback.format_exc())
                    failures.append(cell)
                with open(fname, "w") as f:
                    json.dump(report, f, indent=1, default=str)
                dt = time.perf_counter() - t0
                if report.get("skipped"):
                    print(f"[SKIP] {cell}: {report['why']}", flush=True)
                elif report.get("failed"):
                    print(f"[FAIL] {cell}: {report['error']}", flush=True)
                else:
                    r = report["roofline"]
                    print(f"[ OK ] {cell}: {dt:.0f}s "
                          f"bottleneck={r['bottleneck']} "
                          f"t=({r['t_compute_s']:.2e},{r['t_memory_s']:.2e},"
                          f"{r['t_collective_s']:.2e})s "
                          f"useful={r['useful_flops_ratio']:.2f} "
                          f"mfu={r['mfu']:.2f}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}", flush=True)
        raise SystemExit(1)
    print("\nall dry-run cells passed", flush=True)


if __name__ == "__main__":
    main()
