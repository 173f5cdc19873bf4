"""mfu.prefill (%, program span; layer: model step; moves ttft_p95_ms):
useful prefill FLOPs (real prompt tokens, the head at each prompt's last
position: `harness.flops.prefill_flops`) over the synchronised prefill
wall time of the traced run's unprofiled waves, over 989 TFLOP/s a card
of the cell (a configuration's `mesh` lays the model over that many)."""
from harness.flops import PEAK_BF16, prefill_flops
from harness.spec import mesh_size


def read(run):
    waves = [w for w in run.timed_waves() if w["prefill_s"] is not None]
    if run.kind != "serve" or not waves:
        return None
    work = sum(prefill_flops(run.config, w["lengths"]) for w in waves)
    return 100.0 * work / sum(w["prefill_s"] for w in waves) / PEAK_BF16 \
        / mesh_size(run.config)
