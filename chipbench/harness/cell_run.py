"""One run of one cell: set-up, the measured window, the metrics, and the
comparison that decides `correct`, as the result's line."""
from __future__ import annotations

import math

import torch

from harness import serve, spec, train
from harness.trace import busy_ns, device_ops, idle_gaps

PROGRAMS = {"serve": serve, "train": train}


def readings(cell, seed: int, run, program, device) -> dict:
    """The numbers compared for `correct`, worked out once the program has
    been freed."""
    if run.kind == "serve":
        return serve.readings(cell, seed, run, device)
    ref = train.reference_steps(cell, seed, device,
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


def device_info(cell, run, device) -> dict:
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    if run.trace is not None:
        lo, hi = run.trace.window()
        info["busy_s"] = busy_ns(run.trace, lo, hi) / 1e9
        info["window_s"] = (hi - lo) / 1e9
    return info


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """The result's line of one run, as a dict in the printed order."""
    mod = PROGRAMS[cell.traffic["kind"]]
    program = mod.Program(cell, seed, device, traced)
    run = program.window(seconds, t_start)
    program.close()
    values = readings(cell, seed, run, program, device)
    correct, checks = checks_of(cell, values)
    attempted, failed = attempted_failed(run)
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metric_values(cell, run, traced),
            "device": device_info(cell, run, device)}
    if run.trace is not None:
        line["breakdown"] = {"device_ops": device_ops(run.trace),
                             "idle_gaps": idle_gaps(run.trace)}
    line["checks"] = checks
    return line
