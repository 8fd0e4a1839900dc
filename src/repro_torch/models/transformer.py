"""Model assembly for the dense family: stacked blocks, forward, decode.

Params keep the JAX package's tree: a dict with ``embed``,
``final_norm`` and ``blocks``, whose leaves are stacked with a leading
L axis. The JAX package's ``lax.scan`` over layers becomes a Python loop
over that axis. The other families (moe, ssm, hybrid, audio, vlm) raise
``NotImplementedError`` naming the slice that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (RunConfig, apply_mlp, embed_init,
                                       init_mlp, rms_norm)

# SSM / router leaves that stay f32 through compute-dtype casting
_KEEP_F32 = ("A_log", "dt_bias", "D_skip", "router", "gate")

_SLICE_OF_FAMILY = {
    "moe": "the MoE slice",
    "ssm": "the SSM slice (with kernel K2)",
    "hybrid": "the hybrid slice",
    "audio": "the audio slice",
    "vlm": "the VLM slice",
}


def _require_dense(cfg) -> None:
    if cfg.family != "dense":
        slice_ = _SLICE_OF_FAMILY.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is ported with {slice_}")


def _cast_params(params, rc: RunConfig):
    """Cast every floating leaf to the compute dtype, except leaves whose
    own key contains one of ``_KEEP_F32`` (a substring match, as in the
    JAX package). Norm scales are cast too, so bf16 compute rounds them.
    A leaf already in the compute dtype is returned as it is.
    """
    def cast(name, leaf):
        if isinstance(leaf, dict):
            return {k: cast(k, v) for k, v in leaf.items()}
        if any(k in name for k in _KEEP_F32):
            return leaf
        if leaf.is_floating_point():
            return leaf.to(rc.compute_dtype)
        return leaf
    return {k: cast(k, v) for k, v in params.items()}


def _layer(tree, i: int):
    """The i-th layer's view of a stacked params tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------
def _init_attn_block(gen, cfg, dtype, device):
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        "attn": attn_lib.init_attention(gen, cfg, dtype, device),
        "ln2": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _stack(trees):
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def init_params(cfg, gen: Optional[torch.Generator], rc: RunConfig) -> Dict[str, Any]:
    """Random params with the JAX package's distributions, on ``rc.device``.

    truncated-normal fan-in matrices (``wo`` scaled by 1/sqrt(2L)),
    embeddings N(0, 0.02), zero biases and norms. ``gen`` must live on
    ``rc.device``; it may be None only on the meta device.
    """
    _require_dense(cfg)
    dtype, device = rc.param_dtype, torch.device(rc.device)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_padded, cfg.d_model), dtype, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, (cfg.vocab_padded, cfg.d_model), dtype, device)
    params["blocks"] = _stack([_init_attn_block(gen, cfg, dtype, device)
                               for _ in range(cfg.n_layers)])
    return params


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _apply_attn_block(bp, h, cfg, rc, positions, *, cache=None, cache_index=None,
                      return_kv=False):
    x1 = rms_norm(h, bp["ln1"], cfg.norm_eps)
    a, kv = attn_lib.apply_attention(
        bp["attn"], x1, cfg, rc, positions,
        cache=cache, cache_index=cache_index, return_kv=return_kv)
    h = h + a
    x2 = rms_norm(h, bp["ln2"], cfg.norm_eps)
    h = h + apply_mlp(bp["mlp"], x2, gelu=cfg.gelu_mlp)
    return h, kv


def _logits(params, h, cfg):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = h @ head.T
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------
def forward(params, cfg, rc: RunConfig, *, tokens: torch.Tensor,
            return_cache: bool = False, last_only: bool = False):
    """Full-sequence forward over tokens (B, S).

    Returns (logits, aux_loss, cache). The cache is None unless
    ``return_cache`` (prefill); then it is {"k", "v": (L, B, S, K, hd),
    "pos": S}, with ``pos`` a host int. ``last_only`` emits logits for
    the final position only (what serving prefill needs).
    """
    _require_dense(cfg)
    params = _cast_params(params, rc)
    h = params["embed"][tokens]
    B, S = tokens.shape
    if cfg.scale_embeddings:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=rc.compute_dtype)
    positions = torch.arange(S, device=h.device)[None, :]

    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, kv = _apply_attn_block(_layer(params["blocks"], i), h, cfg, rc,
                                  positions, return_kv=return_cache)
        if return_cache:
            ks.append(kv[0])
            vs.append(kv[1])

    if last_only:
        h = h[:, -1:, :]
    logits = _logits(params, h, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "pos": S} \
        if return_cache else None
    return logits, aux, cache


# ---------------------------------------------------------------------------
# Decode (single token against a cache)
# ---------------------------------------------------------------------------
def init_cache(cfg, rc: RunConfig, batch: int, max_len: int):
    """Zeroed decode cache, the structure forward(return_cache=True) gives."""
    _require_dense(cfg)
    K, hd, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    shape = (L, batch, max_len, K, hd)
    kw = dict(dtype=rc.compute_dtype, device=torch.device(rc.device))
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw), "pos": 0}


def decode_step(params, cfg, rc: RunConfig, cache, tokens: torch.Tensor):
    """One decode step. tokens: (B, 1) int.

    Returns (logits (B, 1, Vp), new_cache). This step's k/v are written
    into ``cache["k"]`` / ``cache["v"]`` in place (the JAX package
    donates the cache); new_cache holds the same tensors and pos + 1.
    ``pos`` is a host int, so a step forces no device sync.
    """
    _require_dense(cfg)
    params = _cast_params(params, rc)
    index = int(cache["pos"])
    h = params["embed"][tokens]
    if cfg.scale_embeddings:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=rc.compute_dtype)
    positions = torch.full(tokens.shape[:1] + (1,), index, device=h.device)

    for i in range(cfg.n_layers):
        h, _ = _apply_attn_block(_layer(params["blocks"], i), h, cfg, rc, positions,
                                 cache=(cache["k"][i], cache["v"][i]),
                                 cache_index=index)

    new_cache = dict(cache)
    new_cache["pos"] = index + 1
    return _logits(params, h, cfg), new_cache
