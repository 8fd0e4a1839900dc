"""Elastic training: node loss -> mesh shrink -> checkpoint restore.

The ElasticRunner owns the fault-tolerance loop of the JAX package's,
over the ranks of ``torch.distributed``'s world (one process per card,
or per CPU rank under gloo):

  1. build a mesh from the currently-healthy ranks,
  2. train with periodic async checkpoints,
  3. on a (simulated or injected) failure, rebuild the mesh from the
     surviving ranks, rebuild the train step, restore the last
     checkpoint INTO THE NEW PLACEMENTS, and continue: the checkpoint
     holds whole tensors, so its layout is mesh-independent (see
     checkpoint/checkpointer.py).

Every rank of the world runs the same runner. ``fail_devices(k)`` takes
the last ``k`` ranks out: every rank takes part in making the survivors'
groups, then the leavers' ``run`` returns and the survivors go on. With
one rank (or no process group) the mesh is None and the step is the
single-device one, as in the JAX package.

The KubeAdaptor engine drives the same loop at the workflow level: a
NodeLost informer event fails the training task pod, the fault-
tolerance module recreates it, and the recreated payload resumes from
the checkpoint here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import make_mesh, mesh_from_ranks
from repro_torch.models import RunConfig
from repro_torch.parallel.mesh import mesh_axes
from repro_torch.parallel.sharding import ShardingPolicy, specs_of, whole
from repro_torch.runtime.train import (TrainRunConfig, build_train_step,
                                       init_sharded_state)

AXES = ("data", "model")


def best_mesh_shape(n_devices: int, prefer_model: int = 0):
    """Largest (data, model) grid over n usable devices (model axis
    fixed if prefer_model given; else the squarest factorization)."""
    if prefer_model and n_devices % prefer_model == 0:
        return (n_devices // prefer_model, prefer_model)
    best = (n_devices, 1)
    for m in range(1, int(n_devices ** 0.5) + 1):
        if n_devices % m == 0:
            best = (n_devices // m, m)
    return best


@dataclass
class ElasticRunner:
    cfg: Any                          # ArchConfig
    B: int
    S: int
    ckpt_dir: str
    rc: RunConfig = field(default_factory=RunConfig)
    trc: TrainRunConfig = field(default_factory=TrainRunConfig)
    policy: ShardingPolicy = field(default_factory=ShardingPolicy)
    ckpt_every: int = 20
    prefer_model: int = 0
    events: List[str] = field(default_factory=list)

    def __post_init__(self):
        self.ckpt = Checkpointer(self.ckpt_dir)
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.devices = list(range(world))
        self.mesh = (make_mesh(best_mesh_shape(world, self.prefer_model), AXES)
                     if world > 1 else None)
        self.left = False
        self.state = None
        self._build()

    def _mesh_shape(self):
        return None if self.mesh is None else mesh_axes(self.mesh)

    def _build(self, restore: bool = True):
        (self.step_fn, self.state_meta, self.batch_meta,
         self.st_sh, self.b_sh, self.model) = build_train_step(
            self.cfg, self.mesh, B=self.B, S=self.S, rc=self.rc,
            policy=self.policy, trc=self.trc)
        if self.state is None and restore and self.ckpt.latest_step() is not None:
            self.state = self.ckpt.restore(self.state_meta, shardings=self.st_sh,
                                           device=self.rc.device)
            self.events.append(f"restored step={self.ckpt.latest_step()} "
                               f"mesh={self._mesh_shape()}")
        elif self.state is None:
            self.state = init_sharded_state(self.model, self.mesh, self.st_sh)
            self.events.append(f"init mesh={self._mesh_shape()}")

    # -- failure handling --------------------------------------------------
    def fail_devices(self, k: int = 1):
        """Simulate losing the last k ranks (a node): shrink and restore.

        Every rank waits for its checkpoint writes, then meets the others
        (the files are on disk for all), then takes part in making the
        survivors' groups; a leaver stops there (``left``)."""
        self.ckpt.wait()
        survivors = self.devices[:-k]
        if not survivors:
            raise RuntimeError("no devices left")
        self.events.append(f"device failure: {len(self.devices)} -> "
                           f"{len(survivors)}")
        self.devices = survivors
        self.state = None
        if dist.is_initialized():
            dist.barrier()
            rank = dist.get_rank()
            self.mesh = (mesh_from_ranks(survivors, best_mesh_shape(
                len(survivors), self.prefer_model), AXES) if len(survivors) > 1 else None)
            if rank not in survivors:
                self.left = True
                self.events.append(f"rank {rank} left the run")
                return
        self._build(restore=True)

    # -- training loop -------------------------------------------------------
    def run(self, data_iter, steps: int,
            on_step: Optional[Callable[[int, Dict], None]] = None,
            fail_at: Optional[int] = None, fail_devices: int = 1) -> Dict:
        """Take ``steps`` steps of ``data_iter``'s host batches (the same
        stream on every rank); a rank that leaves at ``fail_at`` returns
        then, its ``final_step`` None."""
        losses = []
        done = 0
        while done < steps:
            if fail_at is not None and done == fail_at:
                self.fail_devices(fail_devices)
                fail_at = None
                if self.left:
                    return {"losses": losses, "events": list(self.events),
                            "final_step": None}
            batch = next(data_iter)
            specs = None if self.b_sh is None else specs_of(self.b_sh)
            batch = shard_batch(batch, self.mesh, specs, device=self.rc.device)
            self.state, metrics = self.step_fn(self.state, batch)
            done += 1
            losses.append(float(metrics["loss"]))
            if on_step:
                on_step(done, metrics)
            if done % self.ckpt_every == 0 or done == steps:
                self.ckpt.save(self.state, int(whole(self.state.step)))
        self.ckpt.wait()
        return {"losses": losses, "events": list(self.events),
                "final_step": int(whole(self.state.step))}
