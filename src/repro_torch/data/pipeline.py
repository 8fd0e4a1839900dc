"""Data pipeline: deterministic synthetic LM streams, prefetch, device placement.

Synthetic data follows a Zipfian unigram over the vocab with a simple
Markov twist (the next token depends on the current one) so that loss
curves descend, offline and reproducibly. ``SyntheticLM`` makes the
same ``np.random.default_rng`` calls in the same order as the JAX
package's class, so its batches are bit-identical to the reference's.
``shard_batch`` places a host batch on a mesh (``to_device`` without one).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import NamedSharding, place


@dataclass
class DataConfig:
    batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    """Deterministic synthetic token stream: dict batches of tokens/labels."""

    def __init__(self, cfg: DataConfig, frontend: Optional[str] = None,
                 d_model: int = 0, n_img_tokens: int = 0):
        self.cfg = cfg
        self.frontend = frontend
        self.d_model = d_model
        self.n_img_tokens = n_img_tokens
        self.rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.p = p / p.sum()

    def _tokens(self) -> np.ndarray:
        c = self.cfg
        base = self.rng.choice(c.vocab_size, size=(c.batch, c.seq_len + 1), p=self.p)
        # Markov twist: each position repeats (prev + 1) mod V with prob .5
        flip = self.rng.random((c.batch, c.seq_len)) < 0.5
        nxt = (base[:, :-1] + 1) % c.vocab_size
        base[:, 1:] = np.where(flip, nxt, base[:, 1:])
        return base.astype(np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        toks = self._tokens()
        batch: Dict[str, np.ndarray] = {"labels": toks[:, 1:]}
        if self.frontend == "audio":
            emb = self.rng.standard_normal((c.batch, c.seq_len, self.d_model))
            batch["embeds"] = emb.astype(np.float32)
        else:
            batch["tokens"] = toks[:, :-1]
            if self.frontend == "vision":
                img = self.rng.standard_normal((c.batch, self.n_img_tokens, self.d_model))
                batch["img_embeds"] = img.astype(np.float32)
        return batch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch -> contiguous tensors on ``device``, dtypes kept (int32 stays int32)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def shard_batch(batch: Dict[str, np.ndarray], mesh, specs=None, *, device="cuda"):
    """Host batch -> DTensors on ``mesh`` in the placements of ``specs``
    (a PartitionSpec per key, e.g. ``batch_specs``), or without a mesh
    tensors on ``device``. Every rank holds the same host batch (one
    seeded stream each), so each keeps its own rows and nothing is sent."""
    if mesh is None:
        return to_device(batch, device)
    return {k: place(v, NamedSharding(mesh, specs[k]))
            for k, v in to_device(batch, mesh.device_type).items()}


class Prefetcher:
    """Background-thread prefetch (depth N) over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def work():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)
            self.q.put(None)

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
