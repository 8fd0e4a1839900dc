"""llama-3.2-vision-11b — decoder with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified] 40L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=128256. A cross-attention layer (attending
to vision patch embeddings) is inserted after every 5th self-attention
layer. The vision encoder is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings
(B, n_img_tokens, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=128_256,
    rope_theta=500_000.0,
    frontend="vision",
    cross_attn_every=5,
    n_img_tokens=1601,
    source="cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
)
