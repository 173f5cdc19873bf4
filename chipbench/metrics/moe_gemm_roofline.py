"""moe_gemm_roofline (%, device trace; layer: kernels; moves ttft_p95_ms):
the least time the card could take for the routed experts' products of
the traced prefill waves, over the device time of the kernels that ran
them (names matching `PATTERN`, inside the waves' prefill spans).

The work is counted from the wave's prompts, whatever implements it: each
real prompt token of the wave (its `lengths`, not the engine's left
padding) sends `top_k` rows to its experts, and each of a MoE layer's
three products (gate and up: K = d_model, N = d_ff_expert; down:
K = d_ff_expert, N = d_model) takes 2 x rows x K x N FLOPs and reads
every expert's weights once, the rows in once and out once, in
bfloat16.  Needed rows, not the capacity's slots: dropped or padded slots
are not work.  At these shapes the FLOPs bound: 989 TFLOP/s (bf16 tensor
cores), against 3.35 TB/s for the bytes; stated against the 700 W
limit.  A run in which no kernel matches reads nothing: the kernel is
then off the path, and `mfu.prefill` still bounds the whole prefill.
Over a configuration's `mesh` of n cards every rank does 1/n of the
products (the batch split over "data", heads and d_ff over "model"), and
rank 0's kernels are held against 1/n of the least time: each rank reads
at least 1/n of the bytes, so the share is never overstated."""
from harness.flops import HBM_BYTES_PER_S, PEAK_BF16
from harness.spec import mesh_size
from harness.trace import kernel_ns

PATTERN = r"moe_gemm"
ITEM = 2                # bfloat16


def work(config: dict, tokens: int) -> tuple:
    """(FLOPs, bytes) of one prefill over `tokens` tokens."""
    m = config["moe"]
    D, F, E = config["d_model"], m["d_ff_expert"], m["n_routed"]
    rows = tokens * m["top_k"]
    layers = config["n_layers"] - m.get("first_dense_layers", 0)
    flops = nbytes = 0.0
    for K, N in ((D, F), (D, F), (F, D)):
        flops += 2.0 * rows * K * N
        nbytes += ITEM * (E * K * N + rows * K + rows * N)
    return layers * flops, layers * nbytes


def least_seconds(config: dict, tokens: int) -> float:
    flops, nbytes = work(config, tokens)
    return max(flops / PEAK_BF16, nbytes / HBM_BYTES_PER_S)


def read(run):
    if run.kind != "serve" or run.trace is None or not run.config.get("moe"):
        return None
    ns, launches = kernel_ns(run.trace, PATTERN, "chipbench.prefill")
    if not launches:
        return None
    bound = sum(least_seconds(run.config, sum(w["lengths"]))
                for w in run.waves if w["profiled"])
    return 100.0 * bound / mesh_size(run.config) / (ns / 1e9)
