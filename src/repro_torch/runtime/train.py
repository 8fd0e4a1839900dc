"""Train step: loss, gradients (with accumulation), int8 hook, AdamW.

Single-device only: ``mesh`` must be None until the ``parallel/`` slice
ports the sharded paths. The step is functional, as the JAX package's
is: it returns a new ``TrainState`` and leaves its input untouched, so
a caller may keep an old state (to compare, or to resume from). PyTorch
runs eagerly; the JAX package's ``jit`` has no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import Model, RunConfig, build
from repro_torch.optim.adamw import OptConfig, TrainState, apply_updates, init_state
from repro_torch.parallel import compression as comp_lib
from repro_torch.runtime.serve import _require_no_mesh
from repro_torch.runtime.specs import train_batch_specs
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

COMPRESSIONS = (None, "int8")


@dataclass(frozen=True)
class TrainRunConfig:
    opt: OptConfig = field(default_factory=OptConfig)
    grad_accum: int = 1
    compression: Optional[str] = None    # None | "int8"

    def __post_init__(self):
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, not {self.grad_accum}")
        if self.compression not in COMPRESSIONS:
            raise ValueError(f"compression must be one of {COMPRESSIONS}, "
                             f"not {self.compression!r}")


def value_and_grad(loss_fn, params, batch) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads) of ``loss_fn(params, batch)``; grads in each param's dtype.

    The params are taken through detached aliases that require grad, so
    the caller's tensors are neither mutated nor flagged. A leaf that
    the loss does not reach gets zeros, as ``jax.grad`` gives.
    """
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model: Model, trc: TrainRunConfig):
    """``train_step(state, batch) -> (new_state, {"loss", "lr", "grad_norm"})``.

    With ``grad_accum = a`` the batch is cut into ``a`` micro-batches
    along dim 0, their gradients summed in f32 and divided by ``a``, the
    loss averaged. Every metric is a device tensor (no host sync).
    """

    def train_step(state: TrainState, batch):
        if trc.grad_accum > 1:
            a = trc.grad_accum
            micro = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), state.params)
            lsum = torch.zeros((), dtype=torch.float32, device=state.step.device)
            for i in range(a):
                loss, g = value_and_grad(model.loss, state.params,
                                         {k: v[i] for k, v in micro.items()})
                gsum = tree_map(lambda s, x: s + x.float(), gsum, g)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / a, gsum)
            loss = lsum / a
        else:
            loss, grads = value_and_grad(model.loss, state.params, batch)

        if trc.compression == "int8":
            grads = comp_lib.quantize_dequantize_int8(grads)

        with torch.no_grad():
            new_state, metrics = apply_updates(state, grads, trc.opt)
        metrics["loss"] = loss
        return new_state, metrics

    return train_step


def build_train_step(cfg, mesh=None, *, B: int, S: int,
                     rc: Optional[RunConfig] = None,
                     trc: Optional[TrainRunConfig] = None):
    """Returns (step, state_meta, batch_meta, None, None, model).

    ``state_meta`` and ``batch_meta`` hold meta tensors (shapes and
    dtypes, no storage); the two Nones stand where the JAX package
    returns the state's and the batch's shardings.
    """
    _require_no_mesh(mesh, "training")
    trc = trc or TrainRunConfig()
    model = build(cfg, rc or RunConfig())
    state_meta = init_state(model.init_eval_shape())
    return (make_train_step(model, trc), state_meta, train_batch_specs(cfg, B, S),
            None, None, model)


def init_sharded_state(model: Model, mesh=None, st_sh=None, seed: int = 0) -> TrainState:
    """A fresh TrainState on ``model.rc.device``: params from ``seed``."""
    _require_no_mesh(mesh, "training")
    gen = torch.Generator(device=model.rc.device).manual_seed(seed)
    return init_state(model.init(gen))
