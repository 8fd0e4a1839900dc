"""The reference's entry points, by family: ``podbench/reference/<family>.py``
(the configuration's ``arch.family``) gives ``hidden``, and ``prefill``
where its cache is more than each layer's k and v; the loss and the logits
are the same for every family. Each family is handed the configuration's
whole ``reference`` section, its blocking."""
from __future__ import annotations

import importlib

import torch

from podbench.reference import common


def family(arch: dict):
    return importlib.import_module(f"podbench.reference.{arch['family']}")


def hidden(params, arch, tokens, mm, run: dict, **kw):
    return family(arch).hidden(params, arch, tokens, mm, run, **kw)


def loss(params, arch, tokens, labels, mm, run: dict):
    """Mean next-token CE of ``labels`` under the logits of ``tokens``
    (B, S); each layer checkpointed, so the backward fits beside the
    train state."""
    h = hidden(params, arch, tokens, mm, run, remat=True)
    return common.cross_entropy(common.logits(params, h, arch, mm), labels,
                                arch["vocab_size"])


def prefill(params, arch, tokens, mm, run: dict):
    """A prefill of ``tokens`` (B, S): the last position's logits (B, Vp)
    and the cache it hands to decode, {leaf path: tensor}: the family's own
    ``prefill`` where it has one, else "k", "v" (L, B, S, K, hd), stacked
    by layer."""
    fam = family(arch)
    if hasattr(fam, "prefill"):
        h, cache = fam.prefill(params, arch, tokens, mm, run)
    else:
        kv = []
        h = fam.hidden(params, arch, tokens, mm, run, on_kv=lambda i, k, v: kv.append((k, v)))
        cache = dict(zip(("k", "v"), (torch.stack(t) for t in zip(*kv))))
    return common.logits(params, h[:, -1], arch, mm), cache
