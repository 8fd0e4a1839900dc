"""The one traffic generator. A traffic mix is a file of parameters,
``podbench/traffic/<name>.json``:

- ``batch``, ``seq_len``: the rows of a step or of a request batch, and
  the positions of each;
- ``tokens``: how ids are drawn; ``"uniform"`` over the configuration's
  vocabulary, as ``chip_smoke.make_prompts`` draws them;
- ``loop``: ``"steps"`` (a training feed: each step B rows of S + 1 ids,
  the inputs and their next-token labels) or ``"closed"`` (one client
  with a queue of documents: the next batch is sent when the last one's
  first tokens are back).

Batch ``i`` is drawn on the device from its own generator, seeded from
the run's seed and ``i`` alone, so the same seed gives the same batches
in any order, and the reference draws them again.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

DIR = Path(__file__).resolve().parent / "traffic"
LOOPS = ("steps", "closed")
_MASK = (1 << 63) - 1


def load(name: str) -> dict:
    mix = json.loads((DIR / f"{name}.json").read_text())
    if mix["loop"] not in LOOPS or mix["tokens"] != "uniform":
        raise ValueError(f"traffic {name}: loop must be one of {LOOPS}, tokens 'uniform'")
    return mix


def stream_seed(seed: int, stream: int, index: int) -> int:
    """A generator seed for batch ``index`` of ``stream`` under the run's seed."""
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9 + index) & _MASK


class Feed:
    """Batches of a mix for one run. ``stream`` keeps apart draws that must
    not coincide (the window's batches and the warm-up's)."""

    WINDOW, WARMUP = 0, 1

    def __init__(self, mix: dict, vocab_size: int, seed: int, device):
        self.mix, self.vocab, self.seed, self.device = mix, vocab_size, seed, device

    def _ids(self, stream: int, index: int, extra: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(
            stream_seed(self.seed, stream, index))
        shape = (self.mix["batch"], self.mix["seq_len"] + extra)
        return torch.randint(0, self.vocab, shape, generator=gen, device=self.device,
                             dtype=torch.int64).to(torch.int32)

    def batch(self, index: int, stream: int = WINDOW) -> dict:
        """A training batch ({"tokens", "labels"}) or a request batch ({"tokens"})."""
        if self.mix["loop"] == "steps":
            ids = self._ids(stream, index, 1)
            return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
        return {"tokens": self._ids(stream, index, 0)}
