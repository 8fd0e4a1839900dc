"""Per-arch parameter & cache PartitionSpecs.

One rule table maps parameter names to logical axes; ``param_specs``
walks the (possibly stacked) param tree and emits a matching
PartitionSpec tree with divisibility checked against the actual mesh.
The table and the walks are the JAX package's; the tree paths are the
dict keys of ``repro_torch.tree.tree_map_with_keys``.

Policies:
  train:  TP on 'model' + FSDP storage on 'data' (ZeRO-3-style; DTensor
          all-gathers a weight where a layer reads it). Optimizer state
          mirrors param specs.
  serve:  same TP; FSDP kept for storage unless ``fsdp=False``.

Cache specs: batch on dp; kv-heads on tp when divisible else head_dim;
long-context (batch=1) shards the cache *sequence* axis on 'data' (SP).

``to_named`` pairs each spec with its mesh (``NamedSharding``), which
gives the DTensor placements of a tensor of that spec.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.parallel.mesh import (DEFAULT_RULES, P, PartitionSpec, axis_size,
                                       resolve_spec, to_placements)
from repro_torch.tree import tree_map, tree_map_with_keys


@dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = True          # shard param storage over 'data'
    rules: Any = None

    def r(self):
        return self.rules or DEFAULT_RULES


# parameter-name -> logical axes, by trailing dims (leading L handled on top)
# key: substring of the leaf path's last key
_PARAM_AXES = {
    # 2-D (in, out) projections: fsdp on input dim, tp on output dim
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "w1": ("fsdp", "tp"), "w3": ("fsdp", "tp"),
    "in_x": ("fsdp", "tp"), "in_z": ("fsdp", "tp"), "in_dt": ("fsdp", "tp"),
    # (out, in) projections: tp on input dim, fsdp on output dim
    "wo": ("tp", "fsdp"), "w2": ("tp", "fsdp"), "out": ("tp", "fsdp"),
    # small projections (N ~ 64-128): fsdp only
    "in_B": ("fsdp", None), "in_C": ("fsdp", None),
    "router": ("fsdp", None),
    # embeddings: vocab on tp, d_model on fsdp
    "embed": ("tp", "fsdp"), "head": ("tp", "fsdp"),
    # depthwise conv (W, C): channel on tp
    "conv_x": (None, "tp"), "conv_B": (None, None), "conv_C": (None, None),
    # 1-D
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    "gate_norm": ("tp",),
    "ln": (None,), "ln1": (None,), "ln2": (None,), "final_norm": (None,),
    "A_log": (None,), "dt_bias": (None,), "D_skip": (None,),
    "gate": (),
}

# MoE expert tensors are 3-D (E, in, out): experts on tp, fsdp on 'in'
_MOE_AXES = {
    "w1": ("tp", "fsdp", None), "w3": ("tp", "fsdp", None),
    "w2": ("tp", "fsdp", None),
}


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _leaf_axes(keys, leaf) -> tuple:
    name = keys[-1] if keys else ""
    in_moe = "moe" in keys
    stacked = keys and keys[0] in ("blocks", "cross_blocks")
    if in_moe and name in _MOE_AXES and leaf.ndim - (1 if stacked else 0) == 3:
        axes = _MOE_AXES[name]
    elif name in _PARAM_AXES:
        axes = _PARAM_AXES[name]
    else:
        axes = (None,) * leaf.ndim
        stacked = False
    expect = len(axes) + (1 if stacked else 0)
    if leaf.ndim != expect:  # unknown layout: replicate rather than crash
        return (None,) * leaf.ndim
    return ((None,) + tuple(axes)) if stacked else tuple(axes)


def param_specs(params_shape, mesh, policy: ShardingPolicy):
    """PartitionSpec tree matching ``params_shape`` (tensors or meta tensors)."""
    rules = dict(policy.r())
    if not policy.fsdp:
        rules = dict(rules, fsdp=())

    def spec(keys, leaf):
        axes = _leaf_axes(keys, leaf)
        return resolve_spec(mesh, axes, leaf.shape, rules)

    return tree_map_with_keys(spec, params_shape)


def cache_specs(cache_shape, mesh, cfg, shape_cfg, policy: ShardingPolicy):
    """Decode-cache PartitionSpecs (see module docstring).

    ``pos``, a host int in the port's cache, takes ``P()`` as the JAX
    package's int32 scalar does.
    """
    rules = policy.r()
    long_ctx = shape_cfg.global_batch < axis_size(mesh, rules["dp"])

    def spec(keys, leaf):
        name = keys[-1] if keys else ""
        if name == "pos" or leaf.ndim == 0:
            return P()
        if name in ("k", "v", "xk", "xv"):
            # (L, B, T, K, hd)
            axes = [None, "dp", None, "tp", None]
            if leaf.shape[3] % axis_size(mesh, rules["tp"]) != 0:
                axes[3], axes[4] = None, "tp"
            if long_ctx and name in ("k", "v"):
                axes[1], axes[2] = None, "sp"
            return resolve_spec(mesh, axes, leaf.shape, rules)
        if "ssm" in keys:
            # ssd (L,B,H,P,N) / conv tails (L,B,W-1,C)
            if leaf.ndim == 5:
                return resolve_spec(mesh, (None, "dp", "tp", None, None), leaf.shape, rules)
            return resolve_spec(mesh, (None, "dp", None, "tp"), leaf.shape, rules)
        return P(*([None] * leaf.ndim))

    return tree_map_with_keys(spec, cache_shape)


def batch_specs(batch_shape, mesh, policy: ShardingPolicy):
    """Input batch PartitionSpecs: batch dim on dp, rest replicated."""
    rules = policy.r()

    def spec(_, leaf):
        axes = ["dp"] + [None] * (leaf.ndim - 1)
        return resolve_spec(mesh, axes, leaf.shape, rules)

    return tree_map_with_keys(spec, batch_shape)


class NamedSharding:
    """A mesh and a PartitionSpec (the port's ``jax.sharding.NamedSharding``);
    a leaf of the port's sharding trees."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def placements(self, ndim: int) -> tuple:
        return to_placements(self.mesh, self.spec, ndim)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


def place(x, sh: NamedSharding):
    """``x``, a whole tensor that every rank holds alike (made from one seed,
    read from one checkpoint, one host batch), as a DTensor in ``sh``'s
    placements: each rank keeps its own shard and nothing is sent
    (``src_data_rank=None``)."""
    return distribute_tensor(x.to(sh.mesh.device_type), sh.mesh, sh.placements(x.ndim),
                             src_data_rank=None)


def whole(x):
    """A DTensor gathered whole (a collective: every rank of its mesh calls
    it); any other tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


def to_named(tree, mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), tree, is_leaf=_is_spec)


def specs_of(shardings):
    """The PartitionSpec tree of a ``NamedSharding`` tree (for ``shard_batch``)."""
    return tree_map(lambda s: s.spec, shardings, is_leaf=is_sharding)
