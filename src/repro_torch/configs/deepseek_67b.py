"""deepseek-67b — llama-arch dense, 95 layers.

[arXiv:2401.02954; hf] 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab_size=102_400,
    source="llama-arch [arXiv:2401.02954; hf]",
)
