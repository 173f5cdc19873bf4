"""CLI serve entry point (batched requests through the port's token engine),
with the flags of the JAX package's `repro/launch/serve.py` plus `--device`:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --smoke --requests 4 --max-new 16

As in the reference, `--smoke` defaults to on (`action="store_true",
default=True`), so the CLI always serves the reduced config; a full-width
model is served through `ServeEngine` directly (see the README's port
section, and `tests/test_torch_cuda.py`, which serves each decoder at full
width on the card).
The engine runs on `launch.mesh.make_host_mesh()` (every rank of the
initialised process group, or one rank without one), or on the (16, 16)
production mesh under `--production-mesh`, which raises ValueError unless
the world holds 256 ranks, as the reference does without 256 devices.

`--simulate` swaps the token engine for the analytic closed loop
(`repro_torch.serve.simulator`): phase costs are scheduled through an
`ExplorationSession` for a serving workload family on a catalog
accelerator, then a seeded Poisson stream is replayed against them.  Both
modes share the `SlotBatcher` admission policy; the analytic mode never
imports torch.

  PYTHONPATH=src python -m repro_torch.launch.serve --simulate \
      --family transformer --hw-arch mc_hom_tpu --rate 1000 --requests 16
"""
from __future__ import annotations

import argparse
import time


def _run_engine(args):
    import numpy as np

    from repro_torch.configs import ARCHS, reduce_config
    from repro_torch.core.vectorized import resolve_device
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models.module import init_from_specs
    from repro_torch.models.zoo import build_param_specs
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduce_config(cfg)
    device_type = resolve_device(args.device).type
    mesh = (make_production_mesh(device_type=device_type)
            if args.production_mesh
            else make_host_mesh(device_type=device_type))
    params = init_from_specs(build_param_specs(cfg), 0, device=args.device)
    engine = ServeEngine(cfg, params, mesh=mesh, batch_slots=args.batch_slots,
                         max_len=args.prompt_len + args.max_new + 8,
                         prompt_len=args.prompt_len, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, size=args.prompt_len),
                    max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    engine.serve(reqs)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s on "
          f"{engine.device}, mesh {mesh.shape}); peak occupancy "
          f"{engine.max_active}/{engine.B}")
    for i, r in enumerate(reqs):
        print(f"req{i}: {r.out_tokens[:12]}...")
    return reqs


def _run_simulator(args):
    from repro_torch.api.designspace import DesignSpace, GAConfig, ServingSweep
    from repro_torch.api.session import ExplorationSession
    from repro_torch.hw import catalog
    from repro_torch.serve.workloads import serving_workload

    arch = getattr(catalog, args.hw_arch)
    space = DesignSpace(
        workloads={args.family: serving_workload(args.family)},
        archs={args.hw_arch: arch}, granularities=["layer"],
        ga=GAConfig(pop_size=8, generations=4),
        serving=ServingSweep(rates_rps=tuple(args.rate),
                             slo_ms=(args.slo_ms,),
                             batch_slots=args.batch_slots,
                             n_requests=args.requests,
                             decode_tokens=args.max_new))
    sweep = ExplorationSession().run_serving(space)
    for r in sweep.curve(args.family, args.hw_arch):
        print(f"rate {r.rate_rps:>10.1f} rps | p50 {r.p50_ms:8.4f} ms | "
              f"p99 {r.p99_ms:8.4f} ms | qps {r.qps:10.1f} | "
              f"SLO@{r.slo_ms:g}ms {r.slo_attainment:.2f} | "
              f"{r.energy_per_request_pj:.3e} pJ/req")
    return sweep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch-slots", type=int, default=None,
                    help="slot-pool size (default: --requests)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--simulate", action="store_true",
                    help="analytic closed-loop simulator instead of the "
                         "token engine")
    ap.add_argument("--family", default="transformer",
                    choices=["transformer", "rwkv", "ssm"],
                    help="serving workload family (--simulate)")
    ap.add_argument("--hw-arch", default="mc_hom_tpu",
                    help="repro_torch.hw.catalog accelerator name (--simulate)")
    ap.add_argument("--rate", type=float, action="append", default=None,
                    help="arrival rate(s) in req/s (--simulate, repeatable)")
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="latency SLO in ms (--simulate)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    if args.batch_slots is None:
        args.batch_slots = args.requests
    if args.rate is None:
        args.rate = [1000.0]
    if args.simulate:
        return _run_simulator(args)
    return _run_engine(args)


if __name__ == "__main__":
    main()
