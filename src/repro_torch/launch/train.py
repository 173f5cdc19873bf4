"""CLI entry point for training, with the flags of the JAX package's
`repro/launch/train.py` plus `--device`:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

--smoke uses the reduced same-family config; without it the full config is
built.  Parameters are seeded random (`init_from_specs(..., seed)`) on the
device (default cuda; `--device cpu` runs there); the data is
`TokenStream`'s synthetic stream.  Checkpoints every --ckpt-every steps
(async), resumes automatically from --ckpt-dir, logs loss, grad-norm, lr
and step time every 10 steps and at the last.  The step runs the plain
layers (`zoo.train_loss`), so no CUDA kernel of the port launches.
The step runs on `launch.mesh.make_host_mesh()` (every rank of the
initialised process group, or one rank without one), or on the (16, 16)
production mesh under `--production-mesh`, which raises ValueError unless
the world holds 256 ranks, as the reference does without 256 devices.
Every rank draws the same seeded parameters and keeps its blocks of them
and of the optimizer state (`transformer.param_shardings`); checkpoints
hold whole arrays, gathered and written by rank 0, and restore onto any
mesh.  `main(argv)` returns this rank's blocks of the final parameters.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS, reduce_config
from repro_torch.core.vectorized import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.transformer import param_shardings
from repro_torch.models.module import init_from_specs
from repro_torch.models.zoo import build_param_specs
from repro_torch.sharding.rules import (P, NamedSharding, gather_tree,
                                        shard_tree)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.fault_tolerance import resume_or_init
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainStepConfig, init_train_state,
                                          make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduce_config(cfg, n_layers=args.layers, d_model=args.d_model,
                            n_heads=max(4, args.d_model // 64),
                            d_ff=args.d_model * 3, vocab=2048)
    dev = resolve_device(args.device)
    mesh = (make_production_mesh(device_type=dev.type)
            if args.production_mesh else make_host_mesh(device_type=dev.type))
    print(f"arch={cfg.name} device={dev} mesh={mesh.shape}")

    step_cfg = TrainStepConfig(
        microbatches=args.microbatches, remat=True,
        grad_compress=args.grad_compress,
        opt=AdamWConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=min(20, args.steps // 5)))
    pspecs = build_param_specs(cfg)
    params_sh = param_shardings(cfg, mesh)
    state_sh = {"params": params_sh,
                "opt": {"m": params_sh, "v": params_sh,
                        "step": NamedSharding(mesh, P())}}
    if step_cfg.grad_compress:
        state_sh["opt"]["ef"] = params_sh

    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))

    def init_all():
        params = shard_tree(init_from_specs(pspecs, args.seed, device=dev),
                            params_sh)
        return {"params": params,
                "opt": init_train_state(cfg, params, step_cfg)}

    def save(step, state, blocking=True):
        whole = gather_tree(state, state_sh)
        if mesh.rank == 0:
            ckpt.save(args.ckpt_dir, step, whole, blocking=blocking)

    start = 0
    if args.ckpt_dir:
        state, start = resume_or_init(args.ckpt_dir, init_all,
                                      like_tree=None, shardings=None)
        if start:
            print(f"resumed from step {start}")
            tmpl = init_all()
            state = ckpt.restore(args.ckpt_dir, start, like_tree=tmpl,
                                 shardings=state_sh)
    else:
        state = init_all()

    train_step = make_train_step(cfg, mesh, step_cfg)
    params, opt = state["params"], state["opt"]
    del state
    t_last = time.perf_counter()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 data.global_batch(step).items()}
        params, opt, metrics = train_step(params, opt, batch)
        if step % 10 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  ({dt:.2f}s/10steps)",
                  flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(step + 1, {"params": params, "opt": opt}, blocking=False)
    if args.ckpt_dir:
        save(args.steps, {"params": params, "opt": opt})
        ckpt.wait_for_async()
    print("done")
    return params


if __name__ == "__main__":
    main()
