"""Logical-axis rules and sharding helpers over a torch ``DeviceMesh``.

Logical activation/param axes used across the codebase (the JAX package's):
  dp    batch                  -> ("pod", "data")
  fsdp  param-storage shard    -> ("data",)   (ZeRO-3 style, gathered on use)
  tp    tensor-parallel         -> ("model",)
  sp    long-sequence shard     -> ("data",)   (524k KV caches, batch=1)

``resolve_spec`` drops any mesh axis that does not evenly divide the
corresponding dim, so one rule set serves every (arch x shape x mesh)
cell without divisibility landmines (e.g. batch=1 cells simply leave
the dp axes unused).

A spec is a ``PartitionSpec``: one entry per tensor dim, each None, a
mesh axis name or a tuple of names (that dim sharded over all of them,
the first the major). ``to_placements`` turns it into DTensor
placements, one per mesh dim, and ``make_constrain`` gives the
RunConfig hook that redistributes an activation into them: the eager
counterpart of ``jax.lax.with_sharding_constraint``.

The spec functions read only the mesh's axis sizes, so they take a
``DeviceMesh`` or any object whose ``shape`` is a {name: size} mapping
(the sizes of a mesh no process group backs).
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "dp": ("pod", "data"),
    "fsdp": ("data",),
    "tp": ("model",),
    "sp": ("data",),
}


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: per tensor dim, None, an axis name or a
    tuple of axis names (the port's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of ``mesh``, in the mesh's dim order."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def axis_size(mesh, names: Sequence[str]) -> int:
    axes = mesh_axes(mesh)
    size = 1
    for n in names:
        size *= axes.get(n, 1)
    return size


def resolve_spec(mesh, logical_axes: Sequence[Optional[str]],
                 dims: Sequence[int], rules=None) -> PartitionSpec:
    """Logical axes + concrete dims -> PartitionSpec (divisibility-checked)."""
    rules = rules or DEFAULT_RULES
    axes = mesh_axes(mesh)
    out = []
    used = set()
    for ax, dim in zip(logical_axes, dims):
        if ax is None:
            out.append(None)
            continue
        mesh_ax = tuple(a for a in rules.get(ax, ()) if a in axes and a not in used)
        size = axis_size(mesh, mesh_ax)
        if not mesh_ax or size <= 1 or dim % size != 0:
            # try a prefix that divides (e.g. dp=("pod","data") -> ("pod",))
            while mesh_ax and (dim % axis_size(mesh, mesh_ax) != 0):
                mesh_ax = mesh_ax[:-1]
            if not mesh_ax or dim % axis_size(mesh, mesh_ax) != 0:
                out.append(None)
                continue
        used.update(mesh_ax)
        out.append(mesh_ax if len(mesh_ax) > 1 else mesh_ax[0])
    return PartitionSpec(*out)


def to_placements(mesh, spec: Sequence, ndim: int) -> tuple:
    """DTensor placements (one per mesh dim) of a tensor of ``ndim`` dims.

    A mesh dim named in the spec's entry for tensor dim d places
    ``Shard(d)``; every other mesh dim ``Replicate()``. A tuple entry
    shards one tensor dim over several mesh dims, the first named the
    major, which is DTensor's order for repeated ``Shard(d)`` when the
    names come in the mesh's own order; an entry in another order is
    refused.
    """
    names = list(mesh_axes(mesh))
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} names mesh axes out of the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} used twice in {spec}")
            placements[i] = Shard(d)
    return tuple(placements)


def local_offset(x: DTensor, dim: int) -> int:
    """Global index of the first element of this rank's shard of ``x`` along ``dim``.

    DTensor cuts a dim as ``torch.chunk`` does, mesh dim by mesh dim (the
    first the major): pieces of ``ceil(size / n)``, the last ones shorter
    or empty where ``n`` does not divide the size.
    """
    mesh = x.device_mesh
    dim %= x.ndim
    offset, size = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            piece = -(-size // mesh.size(i))
            start = min(piece * mesh.get_local_rank(i), size)
            offset, size = offset + start, min(piece, size - start)
    return offset


def from_local(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """``DTensor.from_local`` of this rank's shard of a tensor of global
    ``shape``. Left to itself DTensor reckons the global shape as if every
    rank's shard were as large as this one's, which an uneven cut breaks:
    a micro-batch of fewer rows than its ranks leaves some ranks one row
    and the rest none (``runtime.train.micro_batch``)."""
    shape = torch.Size(shape)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * max(shape[d + 1], 1)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                              stride=tuple(stride))


def shard_count(x, dim: int) -> int:
    """Into how many shards the DTensor ``x`` cuts dim ``dim`` (1 for a plain tensor)."""
    if not isinstance(x, DTensor):
        return 1
    dim %= x.ndim
    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= x.device_mesh.size(i)
    return n


def replicate_like(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``like``'s mesh when ``like`` is a
    DTensor (a table every rank computes alike: rope angles, masks), else
    ``t`` as it is: DTensor ops refuse a plain tensor beside a DTensor."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def unshard_dim(x, dim: int):
    """``x`` with dim ``dim`` whole on every rank: a DTensor sharded there is
    redistributed with those mesh dims replicated (an all-gather); any
    other tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    placements = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
                  for p in x.placements]
    return x.redistribute(x.device_mesh, placements)


def unbind(x) -> list:
    """``x.unbind(0)``. A DTensor, whose dim 0 no mesh dim may cut (a stacked
    params leaf's layers), is unbound on each rank's shard and each layer
    wrapped with the placements moved one dim down: DTensor's own unbind
    need not exist in every torch. The backward stacks the layers'
    gradients into one buffer in ``x``'s placements, each first brought
    into the layer's placements."""
    if not isinstance(x, DTensor):
        return list(x.unbind(0))
    if any(isinstance(p, Shard) and p.dim == 0 for p in x.placements):
        raise ValueError(f"unbind of a DTensor sharded on dim 0: {x.placements}")
    placements = moved_placements(x.placements, {d: d - 1 for d in range(1, x.ndim)})
    return [from_local(t, x.device_mesh, placements, x.shape[1:])
            for t in x.to_local().unbind(0)]


def reduce_partial(x):
    """``x`` with each ``Partial`` placement summed into ``Replicate()`` (an
    all-reduce); any other tensor is returned as it is."""
    if not isinstance(x, DTensor) or not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                          for p in x.placements])


def grad_placements(x: DTensor, other: DTensor) -> list:
    """The placements of the gradient of ``x.to_local()`` when each rank
    combines its shard of ``x`` with its shard of ``other``: ``x``'s own,
    but ``Partial`` on each mesh dim where ``other`` is sharded and ``x``
    is replicated (each rank's part of ``other`` adds its share)."""
    return [Partial() if isinstance(op, Shard) and isinstance(xp, Replicate) else xp
            for xp, op in zip(x.placements, other.placements)]


def moved_placements(placements, dims) -> list:
    """``placements`` of a tensor carried over to another tensor whose dim
    ``dims[d]`` is this one's dim d: each ``Shard(d)`` becomes
    ``Shard(dims[d])``, or ``Replicate()`` where ``dims`` has no d."""
    return [(Shard(dims[p.dim]) if p.dim in dims else Replicate())
            if isinstance(p, Shard) else p for p in placements]


def split_heads(x, n: int, size: int):
    """(..., n * size) -> (..., n, size). A DTensor whose last dim is sharded
    across head boundaries (n heads on a tp axis that n does not divide)
    is gathered first: DTensor cannot split such columns into heads."""
    if n % shard_count(x, -1):
        x = unshard_dim(x, -1)
    return x.reshape(x.shape[:-1] + (n, size))


def merge_heads(x):
    """(B, S, H, hd), or decode's (B, 1, K, G, hd) -> (B, S, H * hd).

    A DTensor is merged on each rank's shard, keeping its placements, once
    every merged dim but the first is whole (a sharded head_dim or G is
    gathered first); its gradient is redistributed back into those
    placements before the local reshape's backward, which the DTensor
    reshape's own backward could not do from columns sharded across heads.
    """
    if not isinstance(x, DTensor):
        return x.reshape(x.shape[:2] + (-1,))
    for d in range(3, x.ndim):
        x = unshard_dim(x, d)
    local = x.to_local()
    return from_local(local.reshape(local.shape[:2] + (math.prod(local.shape[2:]),)),
                      x.device_mesh, x.placements, x.shape[:2] + (math.prod(x.shape[2:]),))


def make_constrain(mesh, rules=None):
    """RunConfig.constrain hook: constrain(x, logical_axes) -> x.

    Without a mesh, the identity. Otherwise ``x`` (a DTensor on ``mesh``)
    is redistributed into the placements of its resolved spec, except
    that a dim ``x`` already shards over mesh axes its logical axis names
    stays sharded there where the spec drops them for want of
    divisibility: a micro-batch of 16 rows cut over pod x data = 32 ranks
    (``runtime.train.micro_batch``) keeps one row a rank and is not
    gathered onto ``pod`` alone.
    """
    names = list(mesh_axes(mesh)) if mesh is not None else []
    rules = rules or DEFAULT_RULES

    def constrain(x, logical_axes):
        if mesh is None:
            return x
        spec = resolve_spec(mesh, logical_axes, x.shape, rules)
        placements = list(to_placements(mesh, spec, x.ndim))
        for i, p in enumerate(x.placements):
            if (isinstance(p, Shard) and isinstance(placements[i], Replicate)
                    and names[i] in rules.get(logical_axes[p.dim], ())):
                placements[i] = p
        return x.redistribute(mesh, placements)
    return constrain


def make_fsdp_gather(mesh, rules=None):
    """RunConfig.fsdp_gather hook: fsdp_gather(w) -> w gathered over the
    mesh dims of the rules' "fsdp" axis (the ZeRO-3 storage shard), each
    other placement kept (the tp dim stays sharded). A redistribute: its
    backward reduce-scatters w's gradient back into w's placements."""
    names = list(mesh_axes(mesh))
    fsdp = set((rules or DEFAULT_RULES).get("fsdp", ()))

    def gather(w):
        if not isinstance(w, DTensor):
            return w
        placements = [Replicate() if isinstance(p, Shard) and names[i] in fsdp else p
                      for i, p in enumerate(w.placements)]
        if placements == list(w.placements):
            return w
        return w.redistribute(w.device_mesh, placements)
    return gather


def pick_attn_shard(cfg, mesh) -> str:
    """'heads' TP when n_heads divides the tp axis, else q-sequence TP."""
    if mesh is None or not getattr(cfg, "n_heads", 0):
        return "heads"
    tp = mesh_axes(mesh).get("model", 1)
    return "heads" if cfg.n_heads % tp == 0 else "seq"
