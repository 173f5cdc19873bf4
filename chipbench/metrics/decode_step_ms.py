"""decode_step_ms (ms, program span; layer: serve engine; moves
output_tokens_per_s): the median gap between consecutive entries of
`zoo.decode_step` within a wave, over the traced run's unprofiled waves;
each gap holds one step and the engine's read-back of its tokens."""
from harness.stats import gaps, median


def read(run):
    g = [x for w in run.timed_waves() for x in gaps(w["decode_entries"])]
    return 1e3 * median(g) if g else None
