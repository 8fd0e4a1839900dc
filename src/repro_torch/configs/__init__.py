"""Architecture registry of the port: the configs it can serve.

Only the dense qwen2-0.5b is supported so far; other families join the
registry with the slices that port their model code.
"""
from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, shape_applicable

from repro_torch.configs import qwen2_0p5b

_MODULES = (qwen2_0p5b,)

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
