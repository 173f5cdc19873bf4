"""mla_attention_roofline (%, device trace; layer: kernels; moves
ttft_p95_ms): the least time the card could take for MLA's causal prefill
attention of the traced prefill waves, over the device time of the
kernels that ran it (names matching `PATTERN`, inside the waves' prefill
spans).

The work is counted from the wave's prompts, whatever implements it: a
real prompt of L tokens (its `lengths` entry, not the engine's left
padding) attends causally, L (L + 1) / 2 (query, key) pairs a head and
layer, each 2 (qk_nope + qk_rope) FLOPs for its score and 2 v_dim for its
share of the output; the bytes are q, k, v and the output once a token
and head and the shared rope key once a token, in bfloat16, for every
layer.  At these lengths the FLOPs bound: 989 TFLOP/s (bf16 tensor
cores), against 3.35 TB/s for the bytes; stated against the 700 W limit.
A run in which no kernel matches reads nothing: the kernel is then off
the path, and `mfu.prefill` still bounds the whole prefill.  Over a
configuration's `mesh` of n cards every rank attends with 1/n of the
heads, and rank 0's kernels are held against 1/n of the least time: each
rank reads at least 1/n of the bytes, so the share is never
overstated."""
from harness.flops import HBM_BYTES_PER_S, PEAK_BF16
from harness.spec import mesh_size
from harness.trace import kernel_ns

PATTERN = r"mla_attention"
ITEM = 2                # bfloat16


def work(config: dict, lengths: list) -> tuple:
    """(FLOPs, bytes) of one prefill of prompts of `lengths` tokens."""
    m = config["mla"]
    qk, dv = m["qk_nope"] + m["qk_rope"], m["v_dim"]
    H, layers = config["n_heads"], config["n_layers"]
    pairs = sum(n * (n + 1) // 2 for n in lengths)
    tokens = sum(lengths)
    flops = 2.0 * pairs * H * (qk + dv)
    nbytes = ITEM * tokens * (H * (qk + m["qk_nope"] + 2 * dv) + m["qk_rope"])
    return layers * flops, layers * nbytes


def least_seconds(config: dict, lengths: list) -> float:
    flops, nbytes = work(config, lengths)
    return max(flops / PEAK_BF16, nbytes / HBM_BYTES_PER_S)


def read(run):
    if run.kind != "serve" or run.trace is None or \
            run.config.get("mixer") != "mla":
        return None
    ns, launches = kernel_ns(run.trace, PATTERN, "chipbench.prefill")
    if not launches:
        return None
    bound = sum(least_seconds(run.config, w["lengths"])
                for w in run.waves if w["profiled"])
    return 100.0 * bound / mesh_size(run.config) / (ns / 1e9)
