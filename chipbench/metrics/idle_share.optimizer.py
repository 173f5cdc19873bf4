"""idle_share.optimizer (%, program span; layer: train step; moves
train_tokens_per_s): the share of the traced window in which no
operation ran on the device while the driving thread was inside the
program's `train.optimizer` spans (`adamw_update`).  Silent where the
trace holds no such span."""
from harness.phases import idle_share


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return idle_share(run.trace, "train.optimizer")
