"""moe_drop_share (%, program counter; layer: model step; moves
ttft_p95_ms): of the rows the profiled waves' MoE layers routed to an
expert (tokens x top_k, `moe.rows_routed`), the share past the expert's
capacity (`moe.rows_dropped`), whose expert output the layer drops.
Silent without the counters or without a capacity MoE."""
from harness.phases import program_counters


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    c = program_counters()
    routed = c.get("moe.rows_routed", 0.0)
    if not routed:
        return None
    return 100.0 * c["moe.rows_dropped"] / routed
