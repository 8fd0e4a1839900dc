"""Architecture & shape configuration system (the port's own copy).

This is a verbatim copy of the JAX package's ``repro/configs/base.py``:
the port imports nothing from ``repro``, so it keeps the dataclasses it
needs. ``tests/test_torch_layers.py`` holds the two copies field for
field against each other.

Every supported architecture gets one ``repro_torch/configs/<id>.py``
module defining ``CONFIG: ArchConfig`` with the exact published shape.
``ArchConfig.reduced()`` derives a tiny same-family config used by the
CPU parity tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ArchConfig:
    """A single architecture's hyper-parameters (published shapes)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int                        # dense MLP hidden (0 = no MLP)
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # attention details
    qkv_bias: bool = False
    gelu_mlp: bool = False           # True = GeGLU (gemma), False = SwiGLU
    logit_softcap: float = 0.0       # gemma-style final-logit soft cap (0 = off)
    rope_theta: float = 10_000.0
    scale_embeddings: bool = False   # gemma multiplies embeddings by sqrt(d)
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0               # routed experts (0 = dense)
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0               # N (d_state); 0 = no SSM layers
    ssm_head_dim: int = 64           # P
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_conv_width: int = 4
    ssm_chunk: int = 128             # SSD chunk length
    attn_every: int = 0              # hybrid: shared attn block after every N ssm layers

    # modality frontends (STUBS per assignment: precomputed embeddings)
    frontend: Optional[str] = None   # None | 'audio' | 'vision'
    cross_attn_every: int = 0        # vlm: cross-attn layer after every N self layers
    n_img_tokens: int = 1601         # vision stub: patch tokens per image

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    source: str = ""                 # provenance note ([arXiv/hf; tier])

    # ---- derived ----------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over 16-way TP.

        Only mamba2's 50280 actually needs this (-> 50432); padding rows
        are masked out of the loss. Standard Megatron-style practice.
        """
        return _round_up(self.vocab_size, 256)

    @property
    def n_experts_padded(self) -> int:
        """Experts padded to a multiple of 16 for clean EP sharding.

        qwen2-moe's 60 -> 64; the 4 pad experts get -inf router logits.
        """
        if self.n_experts == 0:
            return 0
        return _round_up(self.n_experts, 16)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports 500k-token contexts (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND MODEL_FLOPS and docs)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = 0
        # embeddings (+ untied LM head)
        n += self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "audio", "vlm") or self.attn_every:
            attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
            if self.qkv_bias:
                attn += (self.n_heads + 2 * self.n_kv_heads) * hd
            mlp = 0
            if self.n_experts:
                mlp += self.n_experts * 3 * d * self.expert_d_ff
                mlp += d * self.n_experts  # router
                if self.shared_expert_d_ff:
                    mlp += 3 * d * self.shared_expert_d_ff
            elif self.d_ff:
                mlp += 3 * d * self.d_ff
            block = attn + mlp + 2 * d
        else:
            block = 0
        if self.family in ("ssm", "hybrid"):
            di, N, H = self.ssm_d_inner, self.ssm_state, self.ssm_n_heads
            ssm = d * di * 2            # x, z projections
            ssm += d * N * 2            # B, C projections
            ssm += d * H                # dt projection
            ssm += self.ssm_conv_width * (di + 2 * N)  # causal conv
            ssm += H * 3                # A_log, dt_bias, D
            ssm += di * d               # out proj
            ssm += 2 * d                # norms
            if self.family == "ssm":
                per_layer = ssm
                n += self.n_layers * per_layer
            else:  # hybrid: ssm stack + ONE shared attn/mlp block
                n += self.n_layers * ssm
                n += block              # shared weights counted once
        else:
            per_layer = block
            n += self.n_layers * per_layer
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            cross = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2 + 2 * d
            n += n_cross * cross
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k only) for 6·N_active·D."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        dense_experts = self.n_experts * 3 * d * self.expert_d_ff
        active_experts = self.top_k * 3 * d * self.expert_d_ff
        return self.param_count() - self.n_layers * (dense_experts - active_experts)

    # ---- reduced config for CPU smoke tests --------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for single-CPU smoke tests."""
        changes = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4 if self.attn_every == 0 else 2 * max(self.attn_every, 1)),
            d_model=128,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
        )
        if self.n_experts:
            changes.update(n_experts=8, top_k=min(self.top_k, 2), expert_d_ff=64,
                           n_shared_experts=min(self.n_shared_experts, 1),
                           shared_expert_d_ff=64 if self.shared_expert_d_ff else 0)
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.attn_every:
            changes.update(attn_every=2, n_layers=4)
        if self.cross_attn_every:
            changes.update(cross_attn_every=2, n_layers=4, n_img_tokens=16)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (workload cell)."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned LM shapes. decode_*/long_* lower `serve_step`
# (one new token against a KV cache of seq_len), NOT train_step.
SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k only runs for sub-quadratic families (see DESIGN.md)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True
