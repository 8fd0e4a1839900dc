"""Gradient compression: per-tensor int8 quantization with error feedback.

``quantize_dequantize_int8`` is the stateless hook the train step takes
with ``TrainRunConfig(compression="int8")``: it models the int8 payload
of a gradient exchange. ``ef_compress`` keeps the residual across steps
so that the compression error does not accumulate (error feedback).
Matrices are compressed; tensors of fewer than 2 dims pass as f32.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_map


def _q8(x: torch.Tensor):
    xf = x.float()
    scale = xf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def quantize_dequantize_int8(grads):
    """Simulate an int8-compressed gradient exchange (stateless); f32 out."""
    def f(g):
        if g.dim() < 2:
            return g.float()
        return _dq8(*_q8(g))
    return tree_map(f, grads)


def _is_tuple(x) -> bool:
    return isinstance(x, tuple)


def ef_compress(grads, residual) -> Tuple[Any, Any]:
    """Error-feedback int8: returns (decompressed_grads, new_residual)."""
    def f(g, r):
        if g.dim() < 2:
            return g.float(), torch.zeros_like(r)
        corrected = g.float() + r
        dq = _dq8(*_q8(corrected))
        return dq, corrected - dq
    out = tree_map(f, grads, residual)
    return (tree_map(lambda t: t[0], out, is_leaf=_is_tuple),
            tree_map(lambda t: t[1], out, is_leaf=_is_tuple))


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
