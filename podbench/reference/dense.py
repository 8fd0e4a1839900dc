"""The reference of a dense decoder (Qwen2: GQA with QKV bias, RoPE,
RMSNorm, SwiGLU, tied embedding), in plain PyTorch and float32.

``params`` is the benchmark's weight tree: ``embed`` (Vp, D),
``final_norm``, ``head`` where untied, and ``blocks`` whose leaves stack
the layers on a leading axis.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from podbench.reference import common


def hidden(params, arch, tokens, mm, run: dict, *, remat: bool = False, on_kv=None):
    """The residual stream after the last block, (B, S, D) float32, the
    queries in blocks of ``run["q_block"]`` rows. ``remat``: each block
    checkpointed, recomputed in the backward. ``on_kv(layer, k, v)`` sees
    each layer's rotated k and v."""
    q_block = run["q_block"]
    h = params["embed"][tokens.long()].float()
    for i, bp in enumerate(common.layers(params["blocks"], arch["n_layers"])):
        kv = None if on_kv is None else (lambda k, v, i=i: on_kv(i, k, v))

        def block(x, bp=bp, kv=kv):
            return common.attention_block(bp, x, arch, mm, q_block, kv)
        h = checkpoint(block, h, use_reentrant=False) if remat else block(h)
    return h
