"""idle_share.serve (%, device trace; layer: device; moves
output_tokens_per_s): the share of the traced waves' window in which no
operation ran on the device."""
from harness.trace import busy_ns


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    lo, hi = run.trace.window()
    return 100.0 * (1.0 - busy_ns(run.trace, lo, hi) / (hi - lo))
