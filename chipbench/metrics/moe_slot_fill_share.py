"""moe_slot_fill_share (%, program counter; layer: model step; moves
ttft_p95_ms): of the E x C expert slots the profiled waves' capacity MoE
layers laid out (`moe.slots`), the share that holds a routed row
(`moe.rows_routed` less `moe.rows_dropped`): how much of the expert
products' capacity layout is real rows.  Silent without the counters or
without a capacity MoE."""
from harness.phases import program_counters


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    c = program_counters()
    slots = c.get("moe.slots", 0.0)
    if not slots:
        return None
    return 100.0 * (c["moe.rows_routed"] - c["moe.rows_dropped"]) / slots
