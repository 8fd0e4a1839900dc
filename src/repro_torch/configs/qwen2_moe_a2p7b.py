"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf] 24L d_model=2048 16H (GQA kv=16)
expert d_ff=1408 vocab=151936. Shared expert hidden = 4*1408 = 5632.
60 routed experts are padded to 64 for clean 16-way EP (pad experts get
-inf router logits; see ArchConfig.n_experts_padded).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151_936,
    qkv_bias=True,
    n_experts=60,
    top_k=4,
    expert_d_ff=1408,
    n_shared_experts=4,
    shared_expert_d_ff=5632,
    source="4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
)
