"""Input stand-ins per (arch, shape) cell: meta tensors (shape and dtype,
no storage), the port's counterpart of JAX's ShapeDtypeStruct. They
allocate nothing, so a mesh or a dry run can be planned against them.

The frontends are stubs, as in the JAX package: the audio family takes
frame embeddings (B, S, d_model) in place of tokens, and the vision
family takes tokens plus patch embeddings (B, n_img_tokens, d_model),
both bf16.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


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


def input_specs(cfg: ArchConfig, shape: ShapeConfig, model=None) -> Dict[str, object]:
    """All model inputs for one workload cell, as meta tensors.

    For decode cells this includes the KV/SSM cache of ``shape.seq_len``
    (the cell's definition: one new token against a cache of seq_len),
    with its ``pos`` a host int as in the port's caches.
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, B, S)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, B, S)}
    if shape.kind == "decode":
        if model is None:
            raise ValueError("decode specs need the model for cache shapes")
        return {"cache": model.init_cache_eval_shape(B, S),
                "batch": decode_batch_specs(cfg, B)}
    raise ValueError(shape.kind)
