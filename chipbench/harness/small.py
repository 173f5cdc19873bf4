"""A cell of the manifest cut to a size the CPU tests can hold: the same
configuration family, traffic kind and limits, at small depths, batches
and lengths, and widths at which a wrong token's logit gap is of the size
it has in the cell (RWKV's head reads a 512-wide row).  Only the tests
use it; the benchmark's runs use the cells as the files state them."""
from __future__ import annotations

from harness import spec

SMALL_ARCH = {
    "moe_decoder": dict(n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
                        head_dim=32, vocab=512,
                        moe={"n_routed": 8, "top_k": 2, "n_shared": 1,
                             "d_ff_expert": 64, "first_dense_layers": 1,
                             "d_ff_dense": 256}),
    "rwkv6": dict(n_layers=2, d_model=512, n_heads=8, n_kv_heads=8,
                  head_dim=64, d_ff=512, vocab=512),
}
SMALL_TRAFFIC = {
    "serve": dict(clients=4, batch_slots=4, prompt_len=64, prompt_min=16,
                  length_median=40, length_pool=16, warmup_waves=1,
                  trace_from=1, trace_waves=1, check_waves=2),
    "train": dict(batch=2, seq=64, trace_from=1, trace_steps=1),
}


def small_cell(name: str, dtype: str | None = None):
    """The manifest's cell `name` at a small size (`dtype` overrides the
    configuration's working type)."""
    c = spec.cell(name)
    c.config.update(SMALL_ARCH[c.config["reference"]])
    if dtype:
        c.config["dtype"] = dtype
    c.traffic.update(SMALL_TRAFFIC[c.traffic["kind"]])
    return c
