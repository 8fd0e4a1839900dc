"""mamba2-2.7b — pure Mamba2 (SSD) stack, attention-free.

[arXiv:2405.21060; unverified] 64L d_model=2560, d_ff=0, vocab=50280,
ssm_state=128. d_inner = 2*2560 = 5120, head_dim P=64 -> 80 SSD heads.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=128,
    source="SSD (state-space duality) [arXiv:2405.21060; unverified]",
)
