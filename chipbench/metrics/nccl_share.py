"""nccl_share (%, device trace; layer: collectives; moves ttft_p95_ms): of
rank 0's device busy time inside the traced waves' prefill spans
("chipbench.prefill"), the share taken by NCCL's kernels (names matching
`PATTERN`, each starting inside such a span and clipped to it): the
all-reduces of a tensor-parallel prefill, with the time a rank waits in
them for the other ranks' launches.  A run in which no NCCL kernel ran (one
card, or a program that issues no collective) reads nothing."""
from harness.trace import merged

PATTERN = "nccl"
SPAN = "chipbench.prefill"


def share(trace):
    """100 x NCCL device time over busy device time inside the prefill
    spans of `trace`, or None without an NCCL kernel there."""
    spans = trace.intervals(SPAN)
    nccl = busy = 0
    found = False
    for lo, hi in spans:
        inside = [(n, s, e) for n, s, e in trace.device if lo <= s < hi]
        hits = [(s, min(e, hi)) for n, s, e in inside
                if PATTERN in n.lower()]
        found = found or bool(hits)
        nccl += sum(e - s for s, e in merged(hits, lo, hi))
        busy += sum(e - s for s, e in merged(
            [(s, e) for _, s, e in trace.device], lo, hi))
    if not found or not busy:
        return None
    return 100.0 * nccl / busy


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    return share(run.trace)
