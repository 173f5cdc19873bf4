"""prefill_pad_share (%, program counter; layer: serve engine; moves
ttft_p95_ms): the share of the profiled waves' prefill positions (slots x
`prompt_len`, `serve.prefill_positions`) that hold no prompt token (less
`serve.prefill_tokens`, each admitted prompt's kept length): the left
padding the prefill computes for nothing.  Silent without the counters."""
from harness.phases import program_counters


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    c = program_counters()
    positions = c.get("serve.prefill_positions", 0.0)
    if not positions:
        return None
    return 100.0 * (1.0 - c["serve.prefill_tokens"] / positions)
