"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf] 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048 (EnCodec codebook size). The audio frontend (EnCodec) is a
STUB per the assignment: ``input_specs()`` provides precomputed frame
embeddings (B, S, d_model); the head predicts one codebook stream.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio",
    source="decoder-only over EnCodec tokens [arXiv:2306.05284; hf]",
)
