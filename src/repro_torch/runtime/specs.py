"""Input stand-ins per (arch, shape) cell: meta tensors (shape and dtype,
no storage), the port's counterpart of JAX's ShapeDtypeStruct."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _require_tokens(cfg: ArchConfig) -> None:
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"the {cfg.frontend} frontend is ported with its family's slice")


def train_batch_specs(cfg: ArchConfig, B: int, S: int) -> Dict[str, torch.Tensor]:
    _require_tokens(cfg)
    return {"tokens": _spec((B, S), torch.int32), "labels": _spec((B, S), torch.int32)}


def prefill_batch_specs(cfg: ArchConfig, B: int, S: int) -> Dict[str, torch.Tensor]:
    specs = train_batch_specs(cfg, B, S)
    specs.pop("labels")
    return specs


def decode_batch_specs(cfg: ArchConfig, B: int) -> Dict[str, torch.Tensor]:
    _require_tokens(cfg)
    return {"tokens": _spec((B, 1), torch.int32)}
