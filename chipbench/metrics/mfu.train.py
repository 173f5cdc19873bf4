"""mfu.train (%, program span; layer: train step; moves
train_tokens_per_s): useful FLOPs of a step (`harness.flops.train_flops`,
no recomputation counted) over the synchronised step time of the traced
run's unprofiled steps, over 989 TFLOP/s."""
from harness.flops import PEAK_BF16, train_flops


def read(run):
    steps = run.timed_steps()
    if run.kind != "train" or not steps:
        return None
    tr = run.traffic
    work = train_flops(run.config, tr["batch"], tr["seq"]) * len(steps)
    return 100.0 * work / sum(s["end"] - s["start"] for s in steps) \
        / PEAK_BF16
