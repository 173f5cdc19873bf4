"""output_tokens_per_s (tokens/s, host clock): the tokens served to every
request of the window over the window, which closes when the last wave
started in it has finished."""
from harness.stats import rate


def read(run):
    if run.kind != "serve" or not run.waves:
        return None
    return rate(sum(len(o) for w in run.waves for o in w["out"]),
                *run.window)
