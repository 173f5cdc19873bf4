"""Export Chrome/Perfetto traces for one catalog schedule + one serving run.

    python -m repro_torch.tools.trace_export --out traces [--device cpu]

Schedules fsrcnn on the 4-chiplet homogeneous-TPU catalog architecture
(manual ping-pong allocation — deterministic, no GA), lowers the recorded
schedule to Chrome trace-event JSON (one lane per core / link channel /
DRAM port, fused-segment markers, activation-byte counters), runs the
transformer serving simulator on a seeded Poisson trace with phase costs
taken from real schedules, and writes

    <out>/schedule_trace.json      # load in chrome://tracing or Perfetto
    <out>/serving_trace.json
    <out>/bottleneck.json          # the schedule's bottleneck report
    <out>/bottleneck.txt

Everything written is a pure function of the catalog + seeds: repeated
runs are byte-identical, and equal to the JAX package's `tools/trace_export.py`
on the same catalog and seeds.  `--device` names where the bottleneck
report's `BatchedFitness` is built (None: CUDA, as everywhere in the port);
its lower bound is host arithmetic and launches no kernel.
"""
import argparse
import os
import sys


def export_all(out_dir: str, device=None) -> dict:
    """Write all four artifacts; returns {name: path} (used by tests)."""
    from repro_torch.configs.paper_workloads import fsrcnn
    from repro_torch.core import CostModel, build_graph
    from repro_torch.core.allocator import manual_pingpong
    from repro_torch.core.scheduler import ScheduleEngine
    from repro_torch.core.vectorized import get_batched_fitness
    from repro_torch.hw.catalog import mc_hom_tpu_chip4
    from repro_torch.obs.export import (serving_trace_events,
                                        trace_schedule,
                                        validate_trace_events,
                                        write_chrome_trace)
    from repro_torch.obs.report import bottleneck_report
    from repro_torch.serve.arrivals import poisson_trace
    from repro_torch.serve.simulator import PhaseCosts, simulate
    from repro_torch.serve.workloads import (decode_phase_of,
                                             transformer_phases)

    os.makedirs(out_dir, exist_ok=True)
    paths = {}

    # ---- schedule trace: fsrcnn on the 4-chiplet catalog arch ------------
    workload, acc = fsrcnn(), mc_hom_tpu_chip4()
    graph = build_graph(workload, acc, ("tile", 8, 1))
    engine = ScheduleEngine(graph, CostModel(workload, acc), acc)
    alloc = manual_pingpong(workload, acc)
    events, result = trace_schedule(engine, alloc)
    problems = validate_trace_events(events)
    if problems:
        raise RuntimeError(f"invalid schedule trace: {problems[:3]}")
    paths["schedule"] = write_chrome_trace(
        events, os.path.join(out_dir, "schedule_trace.json"))

    # ---- bottleneck report against the analytical lower bound ------------
    bf = get_batched_fitness(engine, priority="latency", strict_layers=False,
                             device=device)
    lb = float(bf.latency_lower_bound(alloc[None, :])[0])
    report = bottleneck_report(result, lower_bound_cc=lb)
    path = os.path.join(out_dir, "bottleneck.json")
    with open(path, "w") as fh:
        fh.write(report.to_json() + "\n")
    paths["report_json"] = path
    path = os.path.join(out_dir, "bottleneck.txt")
    with open(path, "w") as fh:
        fh.write(report.to_text() + "\n")
    paths["report_text"] = path

    # ---- serving trace: transformer phases, scheduled costs --------------
    tfm = transformer_phases(d_model=64, n_layers=1, seq_len=16)
    costs_of = {}
    for phase_name, wl in (("prefill", tfm),
                           ("decode", decode_phase_of(tfm))):
        g = build_graph(wl, acc, "layer")
        eng = ScheduleEngine(g, CostModel(wl, acc), acc)
        res = eng.schedule(manual_pingpong(wl, acc), "latency",
                           strict_layers=True)
        costs_of[phase_name] = (res.latency_cc, res.energy_pj)
    costs = PhaseCosts(prefill_cc=costs_of["prefill"][0],
                       prefill_pj=costs_of["prefill"][1],
                       decode_cc=costs_of["decode"][0],
                       decode_pj=costs_of["decode"][1])
    trace = poisson_trace(2000.0, 12, seed=0, decode_tokens=4)
    sim = simulate(trace, costs, batch_slots=4)
    sevents = serving_trace_events(sim)
    problems = validate_trace_events(sevents)
    if problems:
        raise RuntimeError(f"invalid serving trace: {problems[:3]}")
    paths["serving"] = write_chrome_trace(
        sevents, os.path.join(out_dir, "serving_trace.json"))
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="traces",
                    help="output directory (default: traces/)")
    ap.add_argument("--device", default=None,
                    help="device of the bottleneck report's batched fitness "
                         "(default: cuda)")
    args = ap.parse_args(argv)
    paths = export_all(args.out, device=args.device)
    for name, path in sorted(paths.items()):
        print(f"{name:12s} {path}")
    with open(paths["report_text"]) as fh:
        print(fh.read())
    return 0


if __name__ == "__main__":
    sys.exit(main())
