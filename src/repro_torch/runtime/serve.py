"""Serving steps: prefill (sequence -> cache) and decode (token + cache).

Single-device only: ``mesh`` must be None until the ``parallel/`` slice
ports the sharded paths. PyTorch runs eagerly, so a step is the model's
own callable; the JAX package's ``jit`` has no counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch.nn.functional as F

from repro_torch.models import RunConfig, build
from repro_torch.runtime.specs import decode_batch_specs, prefill_batch_specs


def _require_no_mesh(mesh, what: str = "serving") -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"sharded {what} (mesh != None) is ported with the parallel/ slice")


def build_prefill_step(cfg, mesh=None, *, B: int, S: int,
                       rc: Optional[RunConfig] = None):
    """Returns (step, params_meta, batch_meta, None, model).

    ``step(params, batch) -> (logits (B, 1, Vp), cache)``.
    """
    _require_no_mesh(mesh)
    model = build(cfg, rc or RunConfig())
    return (model.prefill, model.init_eval_shape(),
            prefill_batch_specs(cfg, B, S), None, model)


def build_decode_step(cfg, shape_cfg, mesh=None, *,
                      rc: Optional[RunConfig] = None):
    """Decode one token against a cache of ``shape_cfg.seq_len``.

    Returns (step, params_meta, cache_meta, batch_meta, None, model).
    ``step(params, cache, batch) -> (logits (B, 1, Vp), cache)`` writes
    the cache in place, as the JAX step donates it. ``seq_len`` sizes the
    k/v of a dense cache and of a hybrid's shared-block applications; the
    SSM state (ssm and hybrid) is the same size whatever ``seq_len`` says.
    """
    _require_no_mesh(mesh)
    model = build(cfg, rc or RunConfig())
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    return (model.decode, model.init_eval_shape(),
            model.init_cache_eval_shape(B, S), decode_batch_specs(cfg, B),
            None, model)


def grow_cache(cache, extra: int):
    """Room for ``extra`` more tokens along a KV cache's T axis, zero-filled.

    The k/v of shape (L, B, T, K, hd) are padded at the end of T, as the
    JAX serving example does with ``jnp.pad`` before it decodes. An SSM
    cache holds a fixed-size state and no k/v: it is returned as it is.
    """
    if "k" not in cache:
        return cache
    pad = (0, 0, 0, 0, 0, extra)            # (L, B, T, K, hd): pad T at its end
    return {**cache, "k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad)}
