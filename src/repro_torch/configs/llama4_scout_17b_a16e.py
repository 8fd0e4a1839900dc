"""llama4-scout-17b-a16e — MoE with 16 routed experts, top-1 + shared.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] 48L d_model=5120
40H (GQA kv=8) d_ff=8192 (expert hidden) vocab=202048, MoE 16e top-1,
one shared expert per layer (early-fusion multimodal in the original;
text backbone here).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    n_experts=16,
    top_k=1,
    expert_d_ff=8192,
    n_shared_experts=1,
    shared_expert_d_ff=8192,
    rope_theta=500_000.0,
    source="MoE, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)
