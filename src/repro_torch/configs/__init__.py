"""Architecture registry of the port: the configs it can serve.

The dense qwen2-0.5b and the SSM mamba2-2.7b are supported so far; other
families join the registry with the slices that port their model code.
"""
from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, shape_applicable

from repro_torch.configs import mamba2_2p7b, qwen2_0p5b

_MODULES = (qwen2_0p5b, mamba2_2p7b)

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
