"""whisper-large-v3 [audio enc-dec]: 32L d_model=1280 20H (kv=20) d_ff=5120
vocab=51866; conv frontend STUB (input_specs provides frame embeddings).
[arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866, mixer="gqa", ffn="gelu", rope="none", norm="ln",
    tie_embeddings=True, enc={"enc_layers": 32, "enc_len": 1500},
    source="arXiv:2212.04356",
)
