"""One run of one cell: set-up, the measured window, the metrics, and the
comparison that decides `correct`, as the result's line.  Over several
cards every rank runs it with its mesh (`harness/ranks.py`) and rank 0
makes the line."""
from __future__ import annotations

import math
import sys

import torch

from harness import ranks, serve, spec, train
from harness.trace import busy_ns, device_ops, idle_gaps

PROGRAMS = {"serve": serve, "train": train}


def readings(cell, seed: int, run, program, devices: list) -> dict:
    """The numbers compared for `correct`, worked out once the program has
    been freed."""
    if run.kind == "serve":
        return serve.readings(cell, seed, run, devices)
    ref = train.reference_steps(cell, seed, devices[0],
                                first_grad=program.first_grad)
    return train.compare({"losses": program.losses,
                          "grad_norms": program.grad_norms,
                          "change_norms": program.change_norms}, ref)


def attempted_failed(run) -> tuple:
    if run.kind == "serve":
        return serve.requests_of(run)
    bad = sum(not s["loss_finite"] for s in run.steps)
    return len(run.steps), bad


def metric_values(cell, run, traced: bool) -> dict:
    """The cell's end-to-end metrics (untraced run) or per-layer metrics
    (traced run) that their readers find, in the manifest's order."""
    out = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def checks_of(cell, values: dict) -> tuple:
    """(correct, {number: {value, limit}}) over the numbers the cell's
    limits file names: each at or under its limit, and finite."""
    checks = {n: {"value": float(values[n]), "limit": float(lim["limit"])}
              for n, lim in cell.limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok and bool(checks), checks


def busy_s(run):
    """Seconds of the traced window in which the device ran something."""
    if run.trace is None:
        return None
    lo, hi = run.trace.window()
    return busy_ns(run.trace, lo, hi) / 1e9


def window_s(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window()
    return (hi - lo) / 1e9


def device_info(cell, run, device) -> dict:
    """The line's `device`; over several cards `busy_s` is the mean of the
    ranks' and the window rank 0's."""
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    if run.trace is not None:
        busy = run.rank_busy_s or [busy_s(run)]
        info["busy_s"] = sum(busy) / len(busy)
        info["window_s"] = window_s(run)
    return info


def across_ranks(run, device) -> list | None:
    """After the window, on every rank of a mesh: the ranks' peaks and busy
    seconds gathered into rank 0's `run`, the process group ended once
    every program is freed.  Rank 0 gets the cell's devices, one a rank,
    for the comparison; the others get None."""
    lockstep = sum(run.lockstep_s) / max(len(run.lockstep_s), 1)
    every = ranks.gather((run.peak_bytes, busy_s(run), window_s(run),
                          lockstep))
    if ranks.release() != 0:
        return None
    run.peak_bytes = max(e[0] for e in every)
    if run.trace is not None:
        run.rank_busy_s = [e[1] for e in every]
    for r, (peak, busy, window, lock) in enumerate(every):
        print(f"rank {r}: peak {peak} bytes, busy {busy!r} s of a traced "
              f"window of {window!r} s, {1e3 * lock:.4f} ms a wave's "
              "broadcast", file=sys.stderr)
    dev = torch.device(device)
    return [torch.device(dev.type, r) if dev.type == "cuda" else dev
            for r in range(len(every))]


def run_once(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, mesh=None) -> tuple:
    """(the result's line, or None on a rank other than 0; the run)."""
    mod = PROGRAMS[cell.traffic["kind"]]
    program = mod.Program(cell, seed, device, traced, mesh)
    run = program.window(seconds, t_start)
    program.close()
    devices = [device]
    if mesh is not None:
        devices = across_ranks(run, device)
        if devices is None:
            return None, run
    values = readings(cell, seed, run, program, devices)
    correct, checks = checks_of(cell, values)
    attempted, failed = attempted_failed(run)
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metric_values(cell, run, traced),
            "device": device_info(cell, run, device)}
    if run.trace is not None:
        line["breakdown"] = {"device_ops": device_ops(run.trace),
                             "idle_gaps": idle_gaps(run.trace)}
    line["checks"] = checks
    return line, run


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, mesh=None) -> dict | None:
    """The result's line of one run, as a dict in the printed order (None
    on a rank other than 0)."""
    return run_once(cell, seed, seconds, traced, device, t_start, mesh)[0]
