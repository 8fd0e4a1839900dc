"""Serving steps: prefill (sequence -> cache) and decode (token + cache).

PyTorch runs eagerly, so a step is the model's own callable; the JAX
package's ``jit`` has no counterpart here. Given a ``DeviceMesh``, the
model runs on DTensors: the RunConfig takes the mesh's ``constrain``
hook and ``attn_shard``, and the shardings the builders return
(``parallel.sharding.NamedSharding`` trees) say where the caller puts
the params, the batch (``data.pipeline.shard_batch``) and the cache.
"""
from __future__ import annotations

from typing import Optional

import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.models import RunConfig, build
from repro_torch.parallel.mesh import make_constrain, make_fsdp_gather, pick_attn_shard
from repro_torch.parallel.sharding import (ShardingPolicy, batch_specs, cache_specs,
                                           is_sharding, param_specs, to_named)
from repro_torch.runtime.specs import decode_batch_specs, prefill_batch_specs
from repro_torch.tree import tree_map


def mesh_runconfig(cfg, mesh, rc: RunConfig, policy: ShardingPolicy) -> RunConfig:
    """``rc`` with the mesh's constrain and FSDP-gather hooks and attention
    sharding (as it is without a mesh)."""
    if mesh is None:
        return rc
    return rc.replace(constrain=make_constrain(mesh, policy.r()),
                      fsdp_gather=make_fsdp_gather(mesh, policy.r()),
                      attn_shard=pick_attn_shard(cfg, mesh))


def build_prefill_step(cfg, mesh=None, *, B: int, S: int,
                       rc: Optional[RunConfig] = None,
                       policy: Optional[ShardingPolicy] = None):
    """Returns (step, params_meta, batch_meta, param_sh, model).

    ``step(params, batch) -> (logits (B, 1, Vp), cache)``. ``param_sh``
    is None without a mesh.
    """
    policy = policy or ShardingPolicy()
    model = build(cfg, mesh_runconfig(cfg, mesh, rc or RunConfig(), policy))
    params_meta = model.init_eval_shape()
    p_sh = None if mesh is None else to_named(param_specs(params_meta, mesh, policy), mesh)
    return model.prefill, params_meta, prefill_batch_specs(cfg, B, S), p_sh, model


def _placed(x, sh):
    """A cache leaf in its sharding's placements (a DTensor leaf only)."""
    if not isinstance(x, DTensor):
        return x
    placements = sh.placements(x.ndim)
    return x if tuple(x.placements) == placements else x.redistribute(sh.mesh, placements)


def build_decode_step(cfg, shape_cfg, mesh=None, *,
                      rc: Optional[RunConfig] = None,
                      policy: Optional[ShardingPolicy] = None):
    """Decode one token against a cache of ``shape_cfg.seq_len``.

    Returns (step, params_meta, cache_meta, batch_meta, shardings, model),
    ``shardings`` None without a mesh, else (param_sh, cache_sh, batch_sh).
    ``step(params, cache, batch) -> (logits (B, 1, Vp), cache)`` writes
    the cache in place, as the JAX step donates it. Under a mesh, a cache
    leaf not yet in its ``cache_specs`` placements is first redistributed
    into them (the JAX step's ``in_shardings``): the returned cache holds
    the placed leaves, and each later step writes their local shards in
    place. ``seq_len`` sizes the self-attention k/v of every attention
    stack and of a hybrid's shared-block applications; the SSM state
    (ssm and hybrid) and a vlm's cross k/v are the same size whatever
    ``seq_len`` says.
    """
    policy = policy or ShardingPolicy()
    model = build(cfg, mesh_runconfig(cfg, mesh, rc or RunConfig(), policy))
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    params_meta = model.init_eval_shape()
    cache_meta = model.init_cache_eval_shape(B, S)
    batch_meta = decode_batch_specs(cfg, B)
    if mesh is None:
        return model.decode, params_meta, cache_meta, batch_meta, None, model
    p_sh = to_named(param_specs(params_meta, mesh, policy), mesh)
    c_sh = to_named(cache_specs(cache_meta, mesh, cfg, shape_cfg, policy), mesh)
    b_sh = to_named(batch_specs(batch_meta, mesh, policy), mesh)

    def decode(params, cache, batch):
        return model.decode(params, tree_map(lambda sh, x: _placed(x, sh), c_sh, cache,
                                             is_leaf=is_sharding), batch)

    return decode, params_meta, cache_meta, batch_meta, (p_sh, c_sh, b_sh), model


def grow_cache(cache, extra: int):
    """Room for ``extra`` more tokens along a KV cache's T axis, zero-filled.

    The self-attention k/v of shape (L, B, T, K, hd) are padded at the
    end of T, as the JAX serving example does with ``jnp.pad`` before it
    decodes. A vlm's cross-attention ``xk``/``xv`` (n_cross, B, N, K, hd)
    hold the image's keys, which do not grow: they, like an SSM state,
    are returned as they are.
    """
    if "k" not in cache:
        return cache
    return {**cache, "k": _pad_time(cache["k"], extra), "v": _pad_time(cache["v"], extra)}


def _pad_time(x, extra: int):
    """(L, B, T, K, hd) padded with ``extra`` zero slots at the end of T. A
    DTensor is padded on each rank's shard (DTensor's own pad fails in its
    redistribution on torch 2.11); one sharded on T is refused."""
    pad = (0, 0, 0, 0, 0, extra)
    if not isinstance(x, DTensor):
        return F.pad(x, pad)
    if Shard(2) in x.placements:
        raise NotImplementedError("growing a sequence-sharded cache")
    return DTensor.from_local(F.pad(x.to_local(), pad), x.device_mesh, x.placements,
                              run_check=False)
