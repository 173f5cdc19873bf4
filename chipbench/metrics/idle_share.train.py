"""idle_share.train (%, device trace; layer: device; moves
train_tokens_per_s): the share of the traced steps' window in which no
operation ran on the device."""
from harness.trace import busy_ns


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    lo, hi = run.trace.window()
    return 100.0 * (1.0 - busy_ns(run.trace, lo, hi) / (hi - lo))
