#!/usr/bin/env python3
"""The readings that the correctness limits are set from, on the card, at
a cell's own size, many seeds in one process (a cell over several cards:
one set of ranks a seed):

    python3 chipbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 3]

For every seed of `--seeds`, the program's numbers as a run compares them
(a serving cell: a short window at the cell's load, then the sampled
waves against the reference; a training cell: its first steps, no
window).  For the seeds of `--control-seeds`, the control's: the
reference computed with every product's operands in float8 e4m3, read as
a run reads the program (serving: at each served position, the gap of the
token the control puts first).  For the seeds of `--fault-seeds`, a
training cell's planted fault: the program's step over half of each
batch's rows.  One JSON line a reading on standard output.  The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time

from run import ROOT, caches_inside_checkout


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def half_batch(zoo):
    """Plant the fault: the loss over the first half of the rows."""
    loss = zoo.train_loss

    def half(cfg, params, batch, **kw):
        n = batch["tokens"].shape[0] // 2
        return loss(cfg, params, {k: v[:n] for k, v in batch.items()}, **kw)
    zoo.train_loss = half
    return loss


def serve_on_rank(cell, seed, seconds, traced, device, t_start, mesh,
                  control=False):
    """A serving cell's readings on one rank (rank 0's; None on the
    others of a mesh)."""
    from harness import serve
    from harness.cell_run import across_ranks
    program = serve.Program(cell, seed, device, traced, mesh)
    run = program.window(seconds, t_start)
    program.close()
    devices = [device] if mesh is None else across_ranks(run, device)
    if devices is None:
        return None
    return serve.readings(cell, seed, run, devices, control=control)


def serve_readings(cell, seed, seconds, control, device):
    """The readings of a short window at the cell's load; a cell with a
    `mesh` runs in its ranks (`harness/ranks.py`), one set a seed."""
    if not cell.config.get("mesh"):
        return serve_on_rank(cell, seed, seconds, False, device,
                             time.perf_counter(), None, control)
    import functools

    import torch

    from harness import ranks
    code, got = ranks.launch(
        cell, seed, seconds, False, time.perf_counter(),
        device_type=torch.device(device).type,
        body=functools.partial(serve_on_rank, control=control))
    if code:
        raise RuntimeError(f"{cell.name}, seed {seed}: the ranks ended "
                           f"with {code}")
    return got


def leaf_gaps(got: list, want: list) -> list:
    """Each leaf's |got - want| / max(want, the median leaf's want)."""
    from harness.stats import median
    med = median(want)
    return [abs(a - b) / max(b, med, 1e-30) for a, b in zip(got, want)]


def details(cell, got: dict, ref: dict) -> dict:
    """The numbers that are read but not compared: each step's relative
    loss gap, and the first clipped gradient's norm gap by the median leaf
    and by the worst leaves; and the worst leaves of the change."""
    from harness import spec
    from harness.weights import leaves
    names = [".".join(p) for p, _ in leaves(
        spec.reference(cell.config).param_layout(cell.config))]
    grad = leaf_gaps(got["grad_norms"], ref["grad_norms"])
    change = leaf_gaps(got["change_norms"], ref["change_norms"])
    order = sorted(range(len(grad)), key=lambda i: -grad[i])
    return {"loss_by_step": [abs(a - b) / abs(b) for a, b in
                             zip(got["losses"], ref["losses"])],
            "grad_median_leaf": sorted(grad)[len(grad) // 2],
            "grad_worst": [[names[i], grad[i]] for i in order[:4]],
            "change_worst": [[names[i], change[i]] for i in sorted(
                range(len(change)), key=lambda i: -change[i])[:4]]}


def apart(got: list, want: list, device) -> list:
    """Each leaf's squared distance between two gradients on the host."""
    import torch
    return [float(torch.sum((a.to(device) - b.to(device)) ** 2))
            for a, b in zip(got, want)]


def train_readings(cell, seed, control, fault, device):
    from harness import train
    from reference import common
    from repro_torch.models import zoo
    out, ref = {}, None
    for kind in ("program", "fault") if fault else ("program",):
        saved = half_batch(zoo) if kind == "fault" else None
        try:
            program = train.Program(cell, seed, device, False)
        finally:
            if saved is not None:
                zoo.train_loss = saved
        got = {"losses": program.losses, "grad_norms": program.grad_norms,
               "change_norms": program.change_norms}
        first = program.first_grad
        program.close()
        if ref is None:
            t0 = time.perf_counter()
            ref = train.reference_steps(cell, seed, device, keep_first=True)
            out["reference_s"] = time.perf_counter() - t0
        got["grad_apart"] = apart(first, ref["first_grad"], device)
        out[kind] = dict(train.compare(got, ref), **details(cell, got, ref))
        del first
    if control:
        low = train.reference_steps(cell, seed, device,
                                    common.Precision("fp8"), keep_first=True)
        low["grad_apart"] = apart(low["first_grad"], ref["first_grad"],
                                  device)
        out["control"] = dict(train.compare(low, ref),
                              **details(cell, low, ref))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    caches_inside_checkout()
    sys.path.insert(1, str(ROOT / "src"))
    import torch

    from harness import spec
    cell = spec.cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "serve":
            got = serve_readings(cell, seed, args.seconds,
                                 seed in args.control_seeds, device)
        else:
            got = train_readings(cell, seed, seed in args.control_seeds,
                                 seed in args.fault_seeds, device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": time.perf_counter() - t0, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
