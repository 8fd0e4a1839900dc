"""Train step: loss, gradients (with accumulation), int8 hook, AdamW.

The step is functional, as the JAX package's is: it returns a new
``TrainState`` and leaves its input untouched, so a caller may keep an
old state (to compare, or to resume from). PyTorch runs eagerly; the
JAX package's ``jit`` has no counterpart here.

Given a ``DeviceMesh``, ``build_train_step`` returns the state's and the
batch's shardings (``parallel.sharding.NamedSharding`` trees, the JAX
step's ``in_shardings``) and a step over DTensors: the model runs with
the mesh's constrain and FSDP-gather hooks, so each layer's gradient
leaves the backward reduce-scattered into its param's placements; any
other gradient is redistributed into them here (the all-reduce of a
replicated leaf, the head's and final norm's), AdamW updates every leaf
in those placements (the
JAX step's ``out_shardings``), and the metrics come back as plain
replicated tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.models import Model, RunConfig, build
from repro_torch.optim.adamw import OptConfig, TrainState, apply_updates, init_state
from repro_torch.parallel import compression as comp_lib
from repro_torch.parallel.mesh import P, from_local, local_offset
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


def _coords(row: int, size: int, sizes) -> tuple:
    """The coordinates, along mesh dims of ``sizes`` (the first the major),
    of the rank that holds ``row`` of ``size`` rows cut as DTensor's
    ``Shard`` cuts them: ``torch.chunk``, mesh dim by mesh dim."""
    out = []
    for n in sizes:
        piece = -(-size // n)
        c = row // piece
        out.append(c)
        row -= c * piece
        size = min(piece, size - c * piece)
    return tuple(out)


def _take(x: torch.Tensor, idx: list) -> torch.Tensor:
    """Rows ``idx`` of ``x``: a view where they run on, else a gather."""
    if not idx:
        return x[:0]
    if idx == list(range(idx[0], idx[0] + len(idx))):
        return x[idx[0]:idx[0] + len(idx)]
    return x.index_select(0, torch.tensor(idx, dtype=torch.long, device=x.device))


def micro_batch(x: torch.Tensor, a: int, i: int) -> torch.Tensor:
    """Micro-batch ``i`` of ``a`` along dim 0: the rows ``[i·m, (i+1)·m)``,
    ``m = B / a``, as one process (and the JAX package's ``split``) cuts them.

    A DTensor batch comes back ``Shard(0)`` over the mesh dims that shard
    the batch's rows (``pod``, ``data``), cut as DTensor cuts: where ``m``
    is smaller than those ranks, each row sits on one rank and the ranks
    past the last row hold none. Only the rows that change rank move: one
    ``all_to_all_single`` over each such mesh dim in turn (a row first
    goes to its new coordinate on the first, then on the next), every
    rank reckoning from the two cuts alone what it sends and receives. No
    rank gathers the batch.
    """
    m = x.shape[0] // a
    if not isinstance(x, DTensor):
        return x.reshape((a, m) + tuple(x.shape[1:]))[i]
    mesh = x.device_mesh
    dims = [d for d, p in enumerate(x.placements) if p == Shard(0)]
    if any(isinstance(p, Partial) or (isinstance(p, Shard) and p.dim)
           for p in x.placements):
        raise ValueError(f"a batch leaf is sharded on its rows alone, not {x.placements}")
    sizes = [mesh.size(d) for d in dims]
    me = tuple(mesh.get_local_rank(d) for d in dims)
    src = [_coords(i * m + r, x.shape[0], sizes) for r in range(m)]
    dst = [_coords(r, m, sizes) for r in range(m)]
    held = [r for r in range(m) if src[r] == me]
    buf = _take(x.to_local(), [i * m + r - local_offset(x, 0) for r in held])
    for j, d in enumerate(dims):
        if all(s[j] == t[j] for s, t in zip(src, dst)):
            continue                              # no row changes rank along d
        send = [[r for r in held if dst[r][j] == p] for p in range(sizes[j])]
        recv = []
        for p in range(sizes[j]):
            peer = me[:j] + (p,) + me[j + 1:]
            recv.append([r for r in range(m) if src[r][j:] == peer[j:]
                         and dst[r][:j + 1] == me[:j + 1]])
        pos = {r: k for k, r in enumerate(held)}
        buf = funcol.all_to_all_single(
            _take(buf, [pos[r] for part in send for r in part]),
            [len(part) for part in recv], [len(part) for part in send], (mesh, d))
        if isinstance(buf, funcol.AsyncCollectiveTensor):
            buf = buf.wait()
        held = [r for part in recv for r in part]
    pos = {r: k for k, r in enumerate(held)}
    buf = _take(buf, [pos[r] for r in sorted(held)])
    placements = [Shard(0) if d in dims else p for d, p in enumerate(x.placements)]
    return from_local(buf, mesh, placements, (m,) + tuple(x.shape[1:]))


def _like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` in its param's placements: a no-op for the blocks' gradients,
    which their layers' gathers reduce-scatter (``transformer._use``)."""
    if isinstance(p, DTensor):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model: Model, trc: TrainRunConfig):
    """``train_step(state, batch) -> (new_state, {"loss", "lr", "grad_norm"})``.

    With ``grad_accum = a`` the batch is cut into ``a`` micro-batches
    along dim 0 as one process cuts it (``micro_batch``: on DTensors each
    spread over the batch's dp ranks), their gradients summed in f32 (in
    place, into one buffer a leaf) and divided by ``a``, the loss averaged.
    Every metric is a device tensor (no host sync). On DTensors, each
    gradient is placed like its param before the int8 hook and AdamW, and
    the metrics are made whole. The step hands its gradients to AdamW,
    which lets each go once its leaf is updated.
    """

    def train_step(state: TrainState, batch):
        if trc.grad_accum > 1:
            a = trc.grad_accum
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), state.params)
            lsum = torch.zeros((), dtype=torch.float32, device=state.step.device)
            for i in range(a):
                loss, g = value_and_grad(model.loss, state.params,
                                         {k: micro_batch(v, a, i) for k, v in batch.items()})
                for s, x, p in zip(tree_leaves(grads), tree_leaves(g),
                                   tree_leaves(state.params)):
                    s.add_(_like_param(x, p))
                del g
                lsum = lsum + loss
            for s in tree_leaves(grads):
                s.div_(a)
            loss = lsum / a
        else:
            loss, grads = value_and_grad(model.loss, state.params, batch)
            grads = tree_map(_like_param, grads, state.params)

        if trc.compression == "int8":
            grads = comp_lib.quantize_dequantize_int8(grads)

        with torch.no_grad():
            new_state, metrics = apply_updates(state, grads, trc.opt, free_grads=True)
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
