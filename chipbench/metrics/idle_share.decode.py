"""idle_share.decode (%, program span; layer: serve engine; moves
output_tokens_per_s): the share of the traced window in which no
operation ran on the device while the driving thread was inside the
program's `serve.decode` spans (`ServeEngine.decode_once`).  Silent
where the trace holds no such span."""
from harness.phases import idle_share


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    return idle_share(run.trace, "serve.decode")
