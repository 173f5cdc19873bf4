"""qwen2-vl-72b [vlm backbone]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE; vision frontend STUB (mrope position ids provided).
[arXiv:2409.12191]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064, rope="mrope", rope_theta=1e6,
    mrope_sections=(16, 24, 24), source="arXiv:2409.12191",
)
