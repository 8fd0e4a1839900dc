"""Architecture registry of the port: the same ten configs as the JAX package's.

Each ``configs/<id>.py`` is a copy of the JAX package's module with its
import rewritten. Every family builds: dense (qwen2-0.5b, qwen2-1.5b,
gemma-7b, deepseek-67b), moe (qwen2-moe-a2.7b, llama4-scout-17b-a16e),
ssm (mamba2-2.7b), hybrid (zamba2-1.2b), audio (musicgen-medium) and vlm
(llama-3.2-vision-11b). deepseek-67b and llama4-scout-17b-a16e do not
fit one card: their shapes are built on the meta device.
"""
from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, shape_applicable

from repro_torch.configs import (deepseek_67b, gemma_7b, llama4_scout_17b_a16e,
                                 llama32_vision_11b, mamba2_2p7b, musicgen_medium,
                                 qwen2_0p5b, qwen2_1p5b, qwen2_moe_a2p7b, zamba2_1p2b)

_MODULES = (mamba2_2p7b, zamba2_1p2b, llama4_scout_17b_a16e, qwen2_moe_a2p7b, qwen2_1p5b,
            gemma_7b, deepseek_67b, qwen2_0p5b, musicgen_medium, llama32_vision_11b)

REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_configs():
    return sorted(REGISTRY)


__all__ = [
    "ArchConfig", "ShapeConfig", "SHAPES", "shape_applicable",
    "REGISTRY", "get_config", "list_configs",
]
