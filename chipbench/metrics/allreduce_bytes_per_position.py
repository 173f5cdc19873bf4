"""allreduce_bytes_per_position (B, program counter; layer: collectives;
moves ttft_p95_ms): the bytes the program's all-reduces carried on rank 0
(`tp.allreduce_bytes`, each call's tensor once) over the prefill
positions of the profiled waves (`serve.prefill_positions`, slots x
`prompt_len`).  The count holds the waves' decode steps too: their
all-reduces of 8 rows add under 0.1% to a 4096-position prefill's.
Silent without the counters (one card, or a program that does not count
its all-reduces)."""
from harness.phases import program_counters


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    c = program_counters()
    nbytes = c.get("tp.allreduce_bytes", 0.0)
    positions = c.get("serve.prefill_positions", 0.0)
    if not nbytes or not positions:
        return None
    return nbytes / positions
