"""The reference's entry points, by family: ``podbench/reference/<family>.py``
gives ``hidden``; the loss and the logits are the same for every family."""
from __future__ import annotations

import importlib

import torch

from podbench.reference import common


def family(arch: dict):
    return importlib.import_module(f"podbench.reference.{arch['family']}")


def hidden(params, arch, tokens, mm, run: dict, **kw):
    return family(arch).hidden(params, arch, tokens, mm, q_block=run["q_block"], **kw)


def loss(params, arch, tokens, labels, mm, run: dict):
    """Mean next-token CE of ``labels`` under the logits of ``tokens``
    (B, S); each layer checkpointed, so the backward fits beside the
    train state."""
    h = hidden(params, arch, tokens, mm, run, remat=True)
    return common.cross_entropy(common.logits(params, h, arch, mm), labels,
                                arch["vocab_size"])


def prefill(params, arch, tokens, mm, run: dict):
    """A prefill of ``tokens`` (B, S): the last position's logits (B, Vp)
    and the cache it hands to decode, stacked by layer: "k", "v"
    (L, B, S, K, hd)."""
    kv = []
    h = hidden(params, arch, tokens, mm, run, on_kv=lambda i, k, v: kv.append((k, v)))
    cache = dict(zip(("k", "v"), (torch.stack(t) for t in zip(*kv))))
    return common.logits(params, h[:, -1], arch, mm), cache
