"""zamba2-1.2b — Mamba2 backbone + ONE shared attention+MLP block.

[arXiv:2411.15242; hf] 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64. The shared transformer block (its weights
counted once) is applied after every 6th Mamba2 layer.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=128,
    attn_every=6,
    source="Mamba2 + shared attn blocks [arXiv:2411.15242; hf]",
)
