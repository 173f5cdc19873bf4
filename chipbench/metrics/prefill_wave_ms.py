"""prefill_wave_ms (ms, program span; layer: serve engine; moves
ttft_p95_ms): the mean wall time of `zoo.prefill` over the traced run's
unprofiled waves, synchronised before and after by the harness's
wrapper."""


def read(run):
    ms = [w["prefill_s"] for w in run.timed_waves()
          if w["prefill_s"] is not None]
    return 1e3 * sum(ms) / len(ms) if ms else None
