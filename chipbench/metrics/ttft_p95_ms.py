"""ttft_p95_ms (ms, host clock): the 95th percentile over every request of
the window of the time from its client's send to its first token on the
host (the entry of its wave's first decode step, which the engine makes
just after reading the tokens back)."""
from harness.stats import quantile


def read(run):
    if run.kind != "serve" or not run.waves:
        return None
    ttft = [w["first"] - w["send"] for w in run.waves for _ in w["out"]]
    return 1e3 * quantile(ttft, 0.95)
