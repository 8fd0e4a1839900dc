"""Public model API: ArchConfig -> init / loss / apply / prefill / decode callables."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.layers import RunConfig, resolve_device


class Model:
    """Thin functional bundle for one architecture.

    Runs on ``rc.device`` (``cuda`` unless the caller asks for ``cpu``);
    building it raises when a CUDA device is asked for and there is none.
    """

    def __init__(self, cfg, rc: Optional[RunConfig] = None):
        self.cfg = cfg
        self.rc = rc or RunConfig()
        resolve_device(self.rc.device)

    # -- parameters -----------------------------------------------------
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random params from ``gen``, a generator on ``rc.device``."""
        return transformer.init_params(self.cfg, gen, self.rc)

    def init_eval_shape(self) -> Dict[str, Any]:
        """The params tree as meta tensors: shapes and dtypes, no storage."""
        return transformer.init_params(self.cfg, None, self.rc.replace(device="meta"))

    # -- training -------------------------------------------------------
    def loss(self, params, batch) -> torch.Tensor:
        """Mean CE of ``batch["labels"]`` (B, S) under the logits of the
        batch's inputs (``apply``), plus 0.01 times the MoE aux loss: an
        f32 scalar that carries the graph back to ``params`` when they
        require grad."""
        logits, aux, _ = self.apply(params, batch, vocab_pieces=True)
        return transformer.lm_loss(logits, batch["labels"], self.cfg, aux)

    # -- forward ----------------------------------------------------------
    def apply(self, params, batch, return_cache: bool = False,
              last_only: bool = False, vocab_pieces: bool = False):
        """Forward over the batch's inputs, by frontend: ``embeds`` (B, S, D)
        for audio, ``tokens`` (B, S) and ``img_embeds`` (B, N, D) for
        vision, ``tokens`` otherwise."""
        cfg = self.cfg
        kw = dict(return_cache=return_cache, last_only=last_only,
                  vocab_pieces=vocab_pieces)
        if cfg.frontend == "audio":
            return transformer.forward(params, cfg, self.rc, embeds=batch["embeds"], **kw)
        if cfg.frontend == "vision":
            return transformer.forward(params, cfg, self.rc, tokens=batch["tokens"],
                                       img_embeds=batch["img_embeds"], **kw)
        return transformer.forward(params, cfg, self.rc, tokens=batch["tokens"], **kw)

    # -- serving ----------------------------------------------------------
    def prefill(self, params, batch):
        logits, _, cache = self.apply(params, batch, return_cache=True,
                                      last_only=True)
        return logits, cache

    def decode(self, params, cache, batch):
        """One token (``embeds`` (B, 1, D) for audio) against ``cache``;
        writes the cache in place."""
        if self.cfg.frontend == "audio":
            return transformer.decode_step(params, self.cfg, self.rc, cache, None,
                                           embeds=batch["embeds"])
        return transformer.decode_step(params, self.cfg, self.rc, cache,
                                       batch["tokens"])

    def init_cache(self, batch: int, max_len: int):
        return transformer.init_cache(self.cfg, self.rc, batch, max_len)

    def init_cache_eval_shape(self, batch: int, max_len: int):
        return transformer.init_cache(self.cfg, self.rc.replace(device="meta"),
                                      batch, max_len)


def build(cfg, rc: Optional[RunConfig] = None) -> Model:
    return Model(cfg, rc)
