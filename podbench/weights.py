"""Weights from the seed, made on the device in the program's tree.

The tree's shapes and dtypes come from the program's meta tree (the
layout it takes its params in); the values are the benchmark's own. One
normal draw a dtype covers every leaf of that dtype, each leaf a view of
it scaled by its rule: fan-in matrices N(0, 1/fan_in) (the residual
outputs further by 1/sqrt(2L)), embeddings N(0, 0.02^2), norm scales and
biases small offsets N(0, 0.02^2). The same seed gives the same weights, so the reference makes them
again rather than read the program's.
"""
from __future__ import annotations

import math

import torch

# rules by a leaf's own key; any other leaf of rank >= 2 is a fan-in matrix
SMALL = ("embed", "head", "ln1", "ln2", "final_norm", "bq", "bk", "bv")
RESIDUAL_OUT = ("wo", "w2")


def flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf}, keys in sorted order at every level."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _fill(key: str, x: torch.Tensor, n_layers: int) -> None:
    """Turn the standard normal draw ``x`` into leaf ``key``'s values, in place."""
    if key in SMALL:
        x.mul_(0.02)
    elif x.dim() >= 2:
        fan_in = x.shape[-2]
        scale = 1.0 / math.sqrt(fan_in)
        if key in RESIDUAL_OUT:
            scale /= math.sqrt(2 * n_layers)
        x.mul_(scale)
    else:
        raise ValueError(f"no init rule for leaf {key!r} of shape {tuple(x.shape)}")


def make(meta_tree: dict, n_layers: int, seed: int, device) -> dict:
    """Leaves of ``meta_tree``'s shapes and dtypes on ``device`` from ``seed``."""
    flat = flatten(meta_tree)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for dtype in sorted({t.dtype for t in flat.values()}, key=str):
        paths = [p for p, t in flat.items() if t.dtype == dtype]
        total = sum(flat[p].numel() for p in paths)
        buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
        off = 0
        for p in paths:
            n = flat[p].numel()
            leaf = buf[off:off + n].view(flat[p].shape)
            _fill(p.rsplit("/", 1)[-1], leaf, n_layers)
            out[p] = leaf
            off += n
    return unflatten(out)
