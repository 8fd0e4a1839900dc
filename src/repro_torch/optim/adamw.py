"""AdamW + warmup-cosine schedule + global-norm clipping (no torch.optim).

The JAX package's optimizer, functional as there: ``apply_updates``
returns a new ``TrainState`` and leaves the old one as it was. Every
scalar stays a device tensor (the step count too), so a step forces no
host sync; the caller runs it under ``torch.no_grad``. On DTensor
leaves the clip norm is the global one (each leaf's square sum is a
Partial sum over its shards that DTensor reduces before the square
root), and every update, elementwise, runs on each rank's local shards
in its leaf's placements.

The update is the JAX package's ``upd``, op for op in its order, so its
results are those of the expression written out; but XLA fuses that
expression into one pass, and PyTorch makes a new tensor of each term.
So each term is written into the new m, v and p or into one f32 scratch
buffer (two where the param is not f32: its f32 update needs one of its
own), and a leaf larger than ``_SLICE_BYTES`` is updated in ``_SLICES``
slices along its first dim (a stacked leaf's layers), the scratch the
size of a slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from torch.distributed.tensor import DTensor

from repro_torch import trace
from repro_torch.parallel.mesh import from_local
from repro_torch.tree import tree_clear, tree_leaves, tree_map, tree_unflatten


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


# a leaf whose f32 size on its rank is above _SLICE_BYTES is updated in
# _SLICES slices along its first dim: the scratch is a slice's, and the host
# issues _SLICES times its ops (not one pass a layer)
_SLICES = 4
_SLICE_BYTES = 1 << 26


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def _update_rows(p, g, m, v, new_p, new_m, new_v, a, q, decay: bool, k) -> None:
    """Rows of one leaf: ``upd`` of the JAX package with each term written
    in place. ``a`` and ``q`` are f32 scratch of the rows' shape (``q`` is
    ``new_p`` itself for an f32 param); ``k`` the step's scalars. Where a
    term's output is not f32 or its input is not, the input is first copied
    into f32 (a mixed op computes in the lower dtype)."""
    scale, lr, b1c, b2c, cfg = k
    if g.dtype == torch.float32:
        torch.mul(g, scale, out=a)                      # g = g.float() * scale
    else:
        a.copy_(g).mul_(scale)
    torch.mul(a, 1 - cfg.b1, out=new_m)                 # m = b1 * m + (1 - b1) * g
    new_m.add_(torch.mul(m, cfg.b1, out=new_v))
    torch.mul(v, cfg.b2, out=new_v)                     # v = b2 * v + (1 - b2) * g^2
    new_v.add_(a.square_().mul_(1 - cfg.b2))
    torch.div(new_m, b1c, out=a)                        # mhat = m / b1c
    torch.div(new_v, b2c, out=q).sqrt_().add_(cfg.eps)  # sqrt(v / b2c) + eps
    a.div_(q)                                           # delta
    f32 = p.dtype == torch.float32
    if decay:                                           # delta += wd * p
        a.add_(torch.mul(p, cfg.weight_decay, out=q) if f32
               else q.copy_(p).mul_(cfg.weight_decay))
    a.mul_(lr)                                          # p - lr * delta
    if f32:
        torch.sub(p, a, out=new_p)
    else:
        new_p.copy_(q.copy_(p).sub_(a))


def _update_leaf(p, g, m, v, k):
    """The new (p, m, v) of one leaf of plain tensors (a DTensor leaf's
    local shards): in ``_SLICES`` slices along dim 0 where its f32 size is
    above ``_SLICE_BYTES``, else whole."""
    new = [torch.empty_like(x) for x in (p, m, v)]
    rows_of = [x.reshape(1) if x.dim() == 0 else x for x in (p, g, m, v, *new)]
    rows = rows_of[0].shape[0]
    step = max(1, -(-rows // (_SLICES if p.numel() * 4 > _SLICE_BYTES else 1)))
    a = torch.empty((min(step, rows),) + rows_of[0].shape[1:], dtype=torch.float32,
                    device=p.device)
    b = None if p.dtype == torch.float32 else torch.empty_like(a)
    for r0 in range(0, rows, step):
        rp, rg, rm, rv, np_, nm, nv = (x[r0:r0 + step] for x in rows_of)
        n = rp.shape[0]
        _update_rows(rp, rg, rm, rv, np_, nm, nv, a[:n], np_ if b is None else b[:n],
                     p.dim() >= 2, k)
    return new


def apply_updates(state: TrainState, grads, cfg: OptConfig, *, free_grads: bool = False
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One AdamW step; returns (new_state, {"lr", "grad_norm"}).

    Gradients are clipped by ``min(1, clip_norm / max(norm, 1e-9))``;
    m and v are f32, bias-corrected; the weight decay is decoupled and
    applies to matrices (ndim >= 2) only; each update is computed in f32
    and cast back to its param's dtype. ``free_grads``: the caller hands
    ``grads`` over (a tree of its own, which it reads no more): its
    containers are emptied and each gradient is let go once its leaf is
    updated, so the step holds no gradient beside the whole new state.
    Inside the span ``adamw``.
    """
    with trace.span("adamw"):
        g_leaves = tree_leaves(grads)
        gnorm = global_norm(g_leaves)
        if free_grads:
            tree_clear(grads)
        del grads
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = state.step + 1
        lr = schedule(step, cfg)
        b1c = 1 - cfg.b1 ** step.float()
        b2c = 1 - cfg.b2 ** step.float()
        k = (_local(scale), _local(lr), _local(b1c), _local(b2c), cfg)

        out = ([], [], [])
        for i, (p, m, v) in enumerate(zip(tree_leaves(state.params), tree_leaves(state.m),
                                          tree_leaves(state.v))):
            g = g_leaves[i]
            if free_grads:
                g_leaves[i] = None
            if isinstance(p, DTensor):
                mesh, pl = p.device_mesh, p.placements
                g, m, v = (x.redistribute(mesh, pl) for x in (g, m, v))
                new = _update_leaf(p.to_local(), g.to_local(), m.to_local(), v.to_local(), k)
                new = [from_local(x, mesh, pl, p.shape) for x in new]
            else:
                new = _update_leaf(p, g, m, v, k)
            del g
            for acc, x in zip(out, new):
                acc.append(x)
        params, m, v = (tree_unflatten(getattr(state, f), x)
                        for f, x in zip(("params", "m", "v"), out))
        return TrainState(params, m, v, step), {"lr": lr, "grad_norm": gnorm}
