"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d_model=2560 ssm_state=64 + shared
attention block (32H kv=32, d_ff=10240) applied every 6 layers.
Sub-quadratic backbone: runs long_500k. [arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000, mixer="mamba2", ffn="none",
    ssm={"d_state": 64, "headdim": 64, "expand": 2},
    hybrid={"attn_every": 6}, subquadratic=True,
    source="arXiv:2411.15242",
)
