"""train_tokens_per_s (tokens/s, host clock): the tokens of every step of
the window over the time from the first step's start to the last step's
end (each step is synchronised)."""
from harness.stats import rate


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    return rate(sum(s["tokens"] for s in run.steps), run.steps[0]["start"],
                run.steps[-1]["end"])
