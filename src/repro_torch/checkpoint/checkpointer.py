"""Checkpoints in the JAX package's on-disk format: npy per leaf + JSON manifest.

A checkpoint written by either package restores in the other:

  * one ``leaf_NNNNN.npy`` per leaf, numbered in sorted key order, and a
    ``manifest.json`` of ``{"step", "leaves": {key: {file, shape, dtype}}}``;
  * keys are JAX's pytree paths, from ``repro_torch.tree`` (a
    ``TrainState`` gives ``.params/blocks/ln1``, ``.m/embed``, ``.step``);
  * bf16 is stored as f32, with its true dtype in the manifest;
  * async: ``save`` copies every leaf to the host and returns; the files
    are written on a background thread (``wait()`` joins it);
  * atomic: files go to ``step_NNNNNNNN.tmp``, renamed to
    ``step_NNNNNNNN`` only after the manifest is written;
  * retention: the ``keep`` most recent steps are kept;
  * sharded: a DTensor leaf is gathered whole (``full_tensor``, a
    collective, so every rank of its mesh calls ``save``) and the mesh's
    first rank writes the files; ``restore(..., shardings=)`` places each
    leaf into its sharding's placements, on a mesh of any shape (the
    files hold whole tensors).
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import is_sharding, place
from repro_torch.tree import tree_flatten_with_path, tree_rebuild


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class Checkpointer:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---- save ------------------------------------------------------------
    def save(self, state: Any, step: int, blocking: bool = False):
        """Copy every leaf of ``state`` to the host, then write (on a thread
        unless ``blocking``). With DTensor leaves every rank of their mesh
        calls it; only the mesh's first rank writes."""
        self.wait()
        host = {}
        writer = True
        for k, v in tree_flatten_with_path(state).items():
            if isinstance(v, DTensor):
                writer = dist.get_rank() == int(v.device_mesh.mesh.min())
                v = v.full_tensor()
            t = torch.as_tensor(v).detach()
            true_dtype = _dtype_name(t.dtype)
            if t.dtype == torch.bfloat16:        # not numpy-native
                t = t.float()
            # a copy even on the CPU, so later writes to the state miss the file
            host[k] = (t.to("cpu", copy=True).numpy(), true_dtype)
        if not writer:
            return

        def write():
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "leaves": {}}
            for i, (key, (arr, true_dtype)) in enumerate(sorted(host.items())):
                fname = f"leaf_{i:05d}.npy"
                np.save(tmp / fname, arr)
                manifest["leaves"][key] = {
                    "file": fname, "shape": list(arr.shape), "dtype": true_dtype}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if blocking:
            write()
            return

        def work():
            try:
                write()
            except Exception as e:      # re-raised by wait()
                self._error = e
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the writer thread; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---- restore -----------------------------------------------------------
    def steps(self):
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if p.is_dir() and not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, target: Any, step: Optional[int] = None, shardings: Any = None,
                device=None) -> Any:
        """Restore into the structure of ``target`` (tensors, meta tensors too).

        Each leaf takes its manifest dtype. ``shardings``: an optional
        tree matching ``target`` of ``parallel.sharding.NamedSharding``;
        each leaf is then placed directly into its (possibly NEW mesh's)
        placements, every rank keeping its own shard of the whole tensor
        it read. Otherwise each leaf goes to ``device``, or to its target
        leaf's device when ``device`` is None. Raises on a shape mismatch
        and on a target leaf the checkpoint lacks; leaves the target lacks
        are skipped.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat_target = tree_flatten_with_path(target)
        flat_sh = ({} if shardings is None else
                   tree_flatten_with_path(shardings, is_leaf=is_sharding))
        restored = {}
        for key, spec in manifest["leaves"].items():
            if key not in flat_target:
                continue
            arr = np.load(d / spec["file"])
            leaf = flat_target[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint {arr.shape} vs "
                                 f"target {tuple(leaf.shape)}")
            sh = flat_sh.get(key)
            dev = sh.mesh.device_type if sh is not None else (
                device if device is not None else leaf.device)
            if torch.device(dev).type == "meta":
                raise ValueError(f"{key}: a meta target needs restore(..., device=)")
            val = torch.from_numpy(arr).to(device=dev, dtype=getattr(torch, spec["dtype"]))
            restored[key] = val if sh is None else place(val, sh)
        missing = set(flat_target) - set(restored)
        if missing:
            raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
        return tree_rebuild(target, restored)
