"""Plain PyTorch versions of the kernels.

The CPU tests hold these against the JAX package's ``kernels/ref.py``;
``chip_smoke.py`` holds each CUDA kernel against them on the card. They
are intentionally the simplest formulations (O(S^2) attention).
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True):
    """Dense reference attention (plain K1). q: (B, S, H, hd), k/v: (B, T, H, hd).

    Computed in f32 throughout; the output takes v's dtype.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        S, T = s.shape[-2], s.shape[-1]
        mask = (torch.arange(S, device=s.device)[:, None]
                >= torch.arange(T, device=s.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(v.dtype)
