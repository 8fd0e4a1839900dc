"""AdamW + warmup-cosine schedule + global-norm clipping (no torch.optim).

The JAX package's optimizer, functional as there: ``apply_updates``
returns a new ``TrainState`` and leaves the old one as it was. Every
scalar stays a device tensor (the step count too), so a step forces no
host sync; the caller runs it under ``torch.no_grad``. On DTensor
leaves the same code is sharded: each leaf's square sum is a Partial
sum over its shards that DTensor reduces before the square root, so
the clip norm is the global one, and every update is elementwise in its
leaf's placements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class TrainState(NamedTuple):
    params: Any
    m: Any
    v: Any
    step: torch.Tensor          # int32 scalar on the params' device


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine to ``lr * min_lr_ratio``, in f32."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params) -> TrainState:
    """f32 zeros for m and v, step 0 (int32), on each param's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return TrainState(params=params, m=tree_map(zeros, params),
                      v=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (leaves in sorted-key order)."""
    total = None
    for g in tree_leaves(tree):
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _is_tuple(x) -> bool:
    return isinstance(x, tuple)


def apply_updates(state: TrainState, grads, cfg: OptConfig
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One AdamW step; returns (new_state, {"lr", "grad_norm"}).

    Gradients are clipped by ``min(1, clip_norm / max(norm, 1e-9))``;
    m and v are f32, bias-corrected; the weight decay is decoupled and
    applies to matrices (ndim >= 2) only; each update is computed in f32
    and cast back to its param's dtype.
    """
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(step, cfg)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, state.params, grads, state.m, state.v)
    params = tree_map(lambda t: t[0], out, is_leaf=_is_tuple)
    m = tree_map(lambda t: t[1], out, is_leaf=_is_tuple)
    v = tree_map(lambda t: t[2], out, is_leaf=_is_tuple)
    return TrainState(params, m, v, step), {"lr": lr, "grad_norm": gnorm}
