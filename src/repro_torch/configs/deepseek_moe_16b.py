"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) vocab=102400,
fine-grained MoE: 2 shared + 64 routed top-6 experts d_ff_expert=1408,
first layer dense (d_ff=10944). [arXiv:2401.06066]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=102400, ffn="moe",
    moe={"n_routed": 64, "top_k": 6, "n_shared": 2, "d_ff_expert": 1408,
         "first_dense_layers": 1, "d_ff_dense": 10944},
    source="arXiv:2401.06066",
)
