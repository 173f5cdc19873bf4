"""idle_share.prefill (%, program span; layer: serve engine; moves
ttft_p95_ms): the share of the traced window in which no operation ran
on the device while the driving thread was inside the program's
`serve.prefill` spans (`ServeEngine.prefill_step`: the padding, the copy
to the card, the forward and the argmax).  Silent where the trace holds
no such span."""
from harness.phases import idle_share


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    return idle_share(run.trace, "serve.prefill")
