"""qwen2-1.5b — dense GQA with QKV bias.

[arXiv:2407.10671; hf] 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    source="GQA, QKV bias [arXiv:2407.10671; hf]",
)
