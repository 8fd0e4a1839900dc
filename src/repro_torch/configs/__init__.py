"""Architecture registry of the port: the configs it can serve.

Supported so far: the dense qwen2-0.5b, qwen2-1.5b, gemma-7b and
deepseek-67b (which the card cannot hold: its shapes are built on the
meta device), the SSM mamba2-2.7b and the hybrid zamba2-1.2b; other
configs join the registry with the slices that port their model code.
"""
from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, shape_applicable

from repro_torch.configs import (deepseek_67b, gemma_7b, mamba2_2p7b, qwen2_0p5b,
                                 qwen2_1p5b, zamba2_1p2b)

_MODULES = (qwen2_0p5b, qwen2_1p5b, mamba2_2p7b, zamba2_1p2b, gemma_7b, deepseek_67b)

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
