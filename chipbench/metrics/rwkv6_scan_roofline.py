"""rwkv6_scan_roofline (%, device trace; layer: kernels; moves
ttft_p95_ms): the least time the card could take for the RWKV6
recurrences of the traced prefill waves, over the device time of the
kernels that ran them (names matching `PATTERN`, inside the waves'
prefill spans).

The work is the recurrence's, per real prompt token (the wave's
`lengths`, not the engine's left padding) and head, whatever implements
it (K = V = head_dim): o_t = r_t S + (r_t . (u * k_t)) v_t and
S = diag(exp(logw_t)) S + k_t^T v_t take 5 K V + 4 K + 2 V operations; the
bytes are r, k, v and o once in bfloat16, logw once and u, the state in
and the state out of each prompt once in float32, for every layer of
the wave.  The bytes bound at these shapes: 3.35 TB/s, against the
operations at 989 TFLOP/s (the card's fastest rate; a float32 recurrence
on CUDA cores would take 67 TFLOP/s); stated against the 700 W limit.
A run in which no kernel matches reads nothing: the kernel is then off
the path, and `mfu.prefill` still bounds the whole prefill.
Over a configuration's `mesh` of n cards every rank does 1/n of the
recurrences (the batch split over "data", the heads over "model"), and
rank 0's kernels are held against 1/n of the least time: each rank reads
at least 1/n of the bytes, so the share is never overstated."""
from harness.flops import HBM_BYTES_PER_S, PEAK_BF16
from harness.spec import mesh_size
from harness.trace import kernel_ns

PATTERN = r"rwkv6_scan"


def work(config: dict, lengths: list) -> tuple:
    """(operations, bytes) of one prefill of prompts of `lengths`
    tokens."""
    K = V = config["head_dim"]
    H = config["d_model"] // K
    batch = len(lengths)
    n = sum(lengths) * H
    ops = n * (5 * K * V + 4 * K + 2 * V)
    nbytes = 2 * n * (3 * K + V) + 4 * (n * K + H * K + 2 * batch * H * K * V)
    return config["n_layers"] * ops, config["n_layers"] * nbytes


def least_seconds(config: dict, lengths: list) -> float:
    ops, nbytes = work(config, lengths)
    return max(ops / PEAK_BF16, nbytes / HBM_BYTES_PER_S)


def read(run):
    if run.kind != "serve" or run.trace is None or \
            run.config.get("mixer") != "rwkv6":
        return None
    ns, launches = kernel_ns(run.trace, PATTERN, "chipbench.prefill")
    if not launches:
        return None
    bound = sum(least_seconds(run.config, w["lengths"])
                for w in run.waves if w["profiled"])
    return 100.0 * bound / mesh_size(run.config) / (ns / 1e9)
