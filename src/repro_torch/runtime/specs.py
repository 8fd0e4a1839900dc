"""Input stand-ins per (arch, shape) cell: meta tensors (shape and dtype,
no storage), the port's counterpart of JAX's ShapeDtypeStruct.

The frontends are stubs, as in the JAX package: the audio family takes
frame embeddings (B, S, d_model) in place of tokens, and the vision
family takes tokens plus patch embeddings (B, n_img_tokens, d_model),
both bf16.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, B: int, S: int) -> Dict[str, torch.Tensor]:
    specs: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "audio":
        specs["embeds"] = _spec((B, S, cfg.d_model), torch.bfloat16)
    else:
        specs["tokens"] = _spec((B, S), torch.int32)
        if cfg.frontend == "vision":
            specs["img_embeds"] = _spec((B, cfg.n_img_tokens, cfg.d_model), torch.bfloat16)
    specs["labels"] = _spec((B, S), torch.int32)
    return specs


def prefill_batch_specs(cfg: ArchConfig, B: int, S: int) -> Dict[str, torch.Tensor]:
    specs = train_batch_specs(cfg, B, S)
    specs.pop("labels")
    return specs


def decode_batch_specs(cfg: ArchConfig, B: int) -> Dict[str, torch.Tensor]:
    if cfg.frontend == "audio":
        return {"embeds": _spec((B, 1, cfg.d_model), torch.bfloat16)}
    return {"tokens": _spec((B, 1), torch.int32)}
