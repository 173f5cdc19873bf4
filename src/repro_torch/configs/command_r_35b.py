"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, no-bias. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab=256000, rope_theta=8e6, tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
