"""rwkv6-3b "Finch" [ssm, attention-free]: 32L d_model=2560 d_ff=8960
vocab=65536, data-dependent decay. Sub-quadratic: runs long_500k.
[arXiv:2404.05892]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab=65536, mixer="rwkv6", ffn="rwkv_cm", rope="none",
    subquadratic=True, source="arXiv:2404.05892",
)
