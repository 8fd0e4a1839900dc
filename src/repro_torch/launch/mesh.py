"""Mesh construction over the ranks of ``torch.distributed``'s world.

Functions, not module-level constants, so importing this module touches
no process group; the caller initialises the default group
(``torch.distributed.init_process_group``) first. The mesh's device type
follows the default group's backend: ``cuda`` under NCCL, ``cpu`` under
gloo (and the ``fake`` backend, which traces a mesh in one process).

Production target: H100 cards, one rank per card.
  single-pod: (data=16, model=16) = 256 ranks
  multi-pod : (pod=2, data=16, model=16) = 512 ranks
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def mesh_device_type() -> str:
    """``cuda`` when the default group runs NCCL, else ``cpu``."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape, axes) -> DeviceMesh:
    """A mesh of ``shape`` over every rank of the world (e.g. (2, 4) on 8 ranks)."""
    return init_device_mesh(mesh_device_type(), tuple(shape), mesh_dim_names=tuple(axes))


def mesh_from_ranks(ranks: Sequence[int], shape, axes) -> Optional[DeviceMesh]:
    """A mesh of ``shape`` over ``ranks``, a subset of the world (the
    survivors of a failure), laid out row-major like ``make_mesh``.

    Every rank of the world must call it: each mesh dim's groups are made
    with ``dist.new_group``, which all ranks of the default group take
    part in, in one order. A rank outside ``ranks`` gets None.
    """
    layout = torch.tensor(list(ranks), dtype=torch.int).reshape(tuple(shape))
    me = dist.get_rank()
    mine = []
    for d in range(layout.ndim):
        rows = layout.movedim(d, -1).reshape(-1, layout.shape[d])
        for row in rows.tolist():
            group = dist.new_group(row)
            if me in row:
                mine.append(group)
    if me not in ranks:
        return None
    return DeviceMesh.from_group(mine, mesh_device_type(), mesh=layout,
                                 mesh_dim_names=tuple(axes))
