"""gemma-7b — dense, GeGLU, head_dim=256, scaled embeddings.

[arXiv:2403.08295; hf] 28L d_model=3072 16H (kv=16) d_ff=24576
vocab=256000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab_size=256_000,
    gelu_mlp=True,
    scale_embeddings=True,
    tie_embeddings=True,
    source="GeGLU, head_dim=256 [arXiv:2403.08295; hf]",
)
