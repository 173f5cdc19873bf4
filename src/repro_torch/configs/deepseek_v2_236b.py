"""deepseek-v2-236b [moe+MLA]: 60L d_model=5120 128H vocab=102400,
MLA kv_lora=512 (qk_nope=128, qk_rope=64, v=128), MoE: 2 shared + 160 routed
top-6 experts d_ff_expert=1536, first layer dense (d_ff=12288).
[arXiv:2405.04434]

The registered config stays the JAX package's twin (full-rank queries,
plain top-6 routing renormalised, no YaRN): the tests hold the two
equal.  The published settings are optional keys of the port's
`ArchConfig`: `mla["q_lora"]` (1536), `moe["n_group"]` (8),
`moe["topk_group"]` (3), `moe["norm_topk"]` (False),
`moe["routed_scaling"]` (16.0) and `rope_scaling` (YaRN, factor 40);
the chip benchmark's configuration file
`chipbench/configs/deepseek-v2-236b.json` sets them.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=1536, vocab=102400, mixer="mla", ffn="moe",
    mla={"kv_lora": 512, "qk_nope": 128, "qk_rope": 64, "v_dim": 128},
    moe={"n_routed": 160, "top_k": 6, "n_shared": 2, "d_ff_expert": 1536,
         "first_dense_layers": 1, "d_ff_dense": 12288},
    source="arXiv:2405.04434",
)
