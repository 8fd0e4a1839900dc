"""AdamW as the cell states it, in float32: clip by the global norm, the
first and second moments with bias correction, decoupled weight decay on
matrices (ndim >= 2), and a learning rate warmed up linearly over
``warmup_steps`` and then cosine-decayed to ``min_lr_ratio`` of its peak
at ``total_steps``."""
from __future__ import annotations

import math

import torch


def lr_at(step: int, opt: dict) -> float:
    warm = step / max(opt["warmup_steps"], 1)
    prog = (step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1)
    prog = min(max(prog, 0.0), 1.0)
    cos = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * (warm if step < opt["warmup_steps"] else cos)


@torch.no_grad()
def step(params: list, grads: list, m: list, v: list, t: int, opt: dict) -> list:
    """Step ``t`` (1-based) on lists of leaves, updated in place. Returns
    the norm of each clipped gradient, as the moments took it."""
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    scale = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(t, opt)
    b1, b2 = opt["b1"], opt["b2"]
    norms = []
    for p, g, mi, vi in zip(params, grads, m, v):
        g = g.float() * scale
        norms.append(torch.linalg.vector_norm(g))
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).add_(g.square(), alpha=1 - b2)
        delta = (mi / (1 - b1 ** t)) / (torch.sqrt(vi / (1 - b2 ** t)) + opt["eps"])
        if p.dim() >= 2:
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)
    return norms
