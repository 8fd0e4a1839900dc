"""Train step: loss, gradients (with accumulation), int8 hook, AdamW.

The step is functional, as the JAX package's is: it returns a new
``TrainState`` and leaves its input untouched, so a caller may keep an
old state (to compare, or to resume from). PyTorch runs eagerly; the
JAX package's ``jit`` has no counterpart here.

Given a ``DeviceMesh``, ``build_train_step`` returns the state's and the
batch's shardings (``parallel.sharding.NamedSharding`` trees, the JAX
step's ``in_shardings``) and a step over DTensors: the model runs with
the mesh's constrain hook, each gradient is redistributed into its
param's placements (the FSDP reduce-scatter, or the all-reduce of a
replicated leaf), AdamW updates every leaf in those placements (the
JAX step's ``out_shardings``), and the metrics come back as plain
replicated tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import Model, RunConfig, build
from repro_torch.optim.adamw import OptConfig, TrainState, apply_updates, init_state
from repro_torch.parallel import compression as comp_lib
from repro_torch.parallel.mesh import P, unshard_dim
from repro_torch.parallel.sharding import (ShardingPolicy, batch_specs, is_sharding,
                                           param_specs, place, to_named, whole)
from repro_torch.runtime.serve import mesh_runconfig
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
    the loss does not reach gets zeros, as ``jax.grad`` gives. A DTensor
    loss is made whole (``full_tensor``) before the backward, so every
    rank seeds it with 1; the grads are then DTensors in whatever
    placements the backward left them.
    """
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, batch)
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def _micro(x: torch.Tensor, a: int, i: int) -> torch.Tensor:
    """Micro-batch ``i`` of ``a`` along dim 0. A DTensor batch is cut on
    each rank's own rows (every micro-batch keeps the batch's placements),
    so no rank gathers another's rows; the micro-batches then hold other
    rows than the unsharded cut, but the mean over all of them is the same.
    Where a rank holds fewer rows than ``a`` (or a number ``a`` does not
    divide), the batch is gathered and cut as one process cuts it, and the
    model places the micro-batch (``rc.constrain``) on the dp axes its rows
    divide."""
    if isinstance(x, DTensor):
        local = x.to_local()
        if local.shape[0] % a == 0:
            part = local.reshape((a, local.shape[0] // a) + tuple(local.shape[1:]))[i]
            return DTensor.from_local(part, x.device_mesh, x.placements, run_check=False)
        x = unshard_dim(x, 0)
    return x.reshape((a, x.shape[0] // a) + tuple(x.shape[1:]))[i]


def _like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    if isinstance(p, DTensor):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model: Model, trc: TrainRunConfig):
    """``train_step(state, batch) -> (new_state, {"loss", "lr", "grad_norm"})``.

    With ``grad_accum = a`` the batch is cut into ``a`` micro-batches
    along dim 0, their gradients summed in f32 and divided by ``a``, the
    loss averaged. Every metric is a device tensor (no host sync). On
    DTensors, each gradient is placed like its param before the int8
    hook and AdamW, and the metrics are made whole.
    """

    def train_step(state: TrainState, batch):
        if trc.grad_accum > 1:
            a = trc.grad_accum
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), state.params)
            lsum = torch.zeros((), dtype=torch.float32, device=state.step.device)
            for i in range(a):
                loss, g = value_and_grad(model.loss, state.params,
                                         {k: _micro(v, a, i) for k, v in batch.items()})
                g = tree_map(_like_param, g, state.params)
                gsum = tree_map(lambda s, x: s + x.float(), gsum, g)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / a, gsum)
            loss = lsum / a
        else:
            loss, grads = value_and_grad(model.loss, state.params, batch)
            grads = tree_map(_like_param, grads, state.params)

        if trc.compression == "int8":
            grads = comp_lib.quantize_dequantize_int8(grads)

        with torch.no_grad():
            new_state, metrics = apply_updates(state, grads, trc.opt)
        metrics = {k: whole(v) for k, v in metrics.items()}
        metrics["loss"] = loss
        return new_state, metrics

    return train_step


def state_shardings(params_meta, mesh, policy: ShardingPolicy) -> TrainState:
    """The TrainState's PartitionSpecs: m and v mirror the params, step is P()."""
    p_specs = param_specs(params_meta, mesh, policy)
    return TrainState(params=p_specs, m=p_specs, v=p_specs, step=P())


def build_train_step(cfg, mesh=None, *, B: int, S: int,
                     rc: Optional[RunConfig] = None,
                     policy: Optional[ShardingPolicy] = None,
                     trc: Optional[TrainRunConfig] = None):
    """Returns (step, state_meta, batch_meta, state_sh, batch_sh, model).

    ``state_meta`` and ``batch_meta`` hold meta tensors (shapes and
    dtypes, no storage); ``state_sh`` and ``batch_sh`` are the state's
    and the batch's ``NamedSharding`` trees, None without a mesh.
    """
    policy = policy or ShardingPolicy()
    trc = trc or TrainRunConfig()
    model = build(cfg, mesh_runconfig(cfg, mesh, rc or RunConfig(), policy))
    params_meta = model.init_eval_shape()
    state_meta = init_state(params_meta)
    batch_meta = train_batch_specs(cfg, B, S)
    step = make_train_step(model, trc)
    if mesh is None:
        return step, state_meta, batch_meta, None, None, model
    st_sh = to_named(state_shardings(params_meta, mesh, policy), mesh)
    b_sh = to_named(batch_specs(batch_meta, mesh, policy), mesh)
    return step, state_meta, batch_meta, st_sh, b_sh, model


def distribute(tree, shardings):
    """Every leaf of ``tree`` as a DTensor in its ``shardings`` leaf's
    placements. Each rank holds the same whole tensor (made from one seed,
    or read from one checkpoint), so each keeps its own shard and nothing
    is sent (``src_data_rank=None``)."""
    return tree_map(lambda sh, x: place(x, sh), shardings, tree, is_leaf=is_sharding)


def init_sharded_state(model: Model, mesh=None, st_sh=None, seed: int = 0) -> TrainState:
    """A fresh TrainState on ``model.rc.device``: params from ``seed``, then
    (given a mesh) each leaf distributed into ``st_sh``."""
    gen = torch.Generator(device=model.rc.device).manual_seed(seed)
    state = init_state(model.init(gen))
    return state if mesh is None else distribute(state, st_sh)
