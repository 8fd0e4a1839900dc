"""Model assembly for the dense, ssm and hybrid families: stacked blocks,
forward, decode.

Params keep the JAX package's tree: a dict with ``embed``,
``final_norm`` and ``blocks``, whose leaves are stacked with a leading
L axis. The JAX package's ``lax.scan`` over layers becomes a Python loop
over that axis. The hybrid family (zamba2) runs its Mamba2 stack in
segments of ``attn_every`` layers and applies ONE unstacked attention +
MLP block, ``shared_block``, after every full segment; a shorter last
segment gets none. The other families (moe, audio, vlm) raise
``NotImplementedError`` naming the slice that ports them.

With ``RunConfig.remat`` each layer's block is checkpointed under a
gradient (``_maybe_remat``), as the JAX package wraps its scan bodies;
the hybrid's shared block is not, as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (RunConfig, apply_mlp, embed_init,
                                       init_mlp, rms_norm, softmax_cross_entropy)

# SSM / router leaves that stay f32 through compute-dtype casting
_KEEP_F32 = ("A_log", "dt_bias", "D_skip", "router", "gate")

_PORTED_FAMILIES = ("dense", "ssm", "hybrid")
_SLICE_OF_FAMILY = {
    "moe": "the MoE slice",
    "audio": "the audio slice",
    "vlm": "the VLM slice",
}


def _require_ported(cfg) -> None:
    if cfg.family not in _PORTED_FAMILIES:
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


def _segments(n_layers: int, every: int):
    """[(a, b, apply_shared_after), ...] covering n_layers in runs of
    ``every`` (the JAX package's): only a full run is followed by the
    shared block, so a shorter last run (38 = 6 * 6 + 2) gets none."""
    segs = []
    a = 0
    while a < n_layers:
        b = min(a + every, n_layers)
        segs.append((a, b, b - a == every))
        a = b
    return segs


def _mamba_segments(cfg):
    """The Mamba2 stack's segments: the hybrid's, or one run without the
    shared block for the ssm family."""
    if cfg.family == "hybrid":
        return _segments(cfg.n_layers, cfg.attn_every)
    return [(0, cfg.n_layers, False)]


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


def _init_mamba_block(gen, cfg, dtype, device):
    return {
        "ln": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        "mamba": ssm_lib.init_mamba(gen, cfg, dtype, device),
    }


def _stack(trees):
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def init_params(cfg, gen: Optional[torch.Generator], rc: RunConfig) -> Dict[str, Any]:
    """Random params with the JAX package's distributions, on ``rc.device``.

    truncated-normal fan-in matrices (``wo`` and the Mamba2 ``out``
    scaled by 1/sqrt(2L)), embeddings N(0, 0.02), zero biases and norms,
    and the Mamba2 leaves of ``ssm.init_mamba``. ``gen`` must live on
    ``rc.device``; it may be None only on the meta device.
    """
    _require_ported(cfg)
    dtype, device = rc.param_dtype, torch.device(rc.device)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_padded, cfg.d_model), dtype, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, (cfg.vocab_padded, cfg.d_model), dtype, device)
    init_block = _init_attn_block if cfg.family == "dense" else _init_mamba_block
    params["blocks"] = _stack([init_block(gen, cfg, dtype, device)
                               for _ in range(cfg.n_layers)])
    if cfg.family == "hybrid":
        params["shared_block"] = _init_attn_block(gen, cfg, dtype, device)
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


def _apply_mamba_block(bp, h, cfg, rc, *, state=None, return_state=False):
    x1 = rms_norm(h, bp["ln"], cfg.norm_eps)
    y, new_state = ssm_lib.apply_mamba(bp["mamba"], x1, cfg, rc, state=state,
                                       return_state=return_state)
    return h + y, new_state


# what ``remat_policy="dots"`` saves: the outputs of the matmuls, as
# ``jax.checkpoint_policies.checkpoint_dots`` saves those of dot_general
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _maybe_remat(fn, rc: RunConfig):
    """``fn`` checkpointed as the JAX package's ``_maybe_remat`` does.

    ``remat`` off: ``fn`` itself. ``remat_policy="dots"``: a selective
    checkpoint that saves the matmul outputs (``_DOTS``) and recomputes
    the rest. Any other policy: a plain checkpoint that recomputes all of
    ``fn`` in the backward (``jax.checkpoint(fn)``). Without grad mode
    ``fn`` runs as it is: there is no backward to recompute for.
    """
    if not rc.remat:
        return fn
    kw = {"use_reentrant": False}
    if rc.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             list(_DOTS))

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, **kw)
    return remat


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
    "pos": S} for the dense family, {"ssm": SSMState stacked over L,
    "pos": S} for the ssm family, and for the hybrid that state plus the
    shared block's "k", "v": (n_apps, B, S, K, hd), one per application;
    ``pos`` is a host int. ``last_only`` emits logits for the final
    position only (what serving prefill needs).
    """
    _require_ported(cfg)
    params = _cast_params(params, rc)
    h = params["embed"][tokens]
    B, S = tokens.shape
    if cfg.scale_embeddings:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=rc.compute_dtype)

    cache = None
    positions = torch.arange(S, device=h.device)[None, :]
    ks, vs = [], []
    if cfg.family in ("ssm", "hybrid"):
        states = (ssm_lib.init_ssm_state(cfg, B, rc.compute_dtype, h.device,
                                         layers=cfg.n_layers)
                  if return_cache else None)
        mamba_block = _maybe_remat(lambda bp, hh: _apply_mamba_block(
            bp, hh, cfg, rc, return_state=return_cache), rc)
        for a, b, shared in _mamba_segments(cfg):
            for i in range(a, b):
                h, st = mamba_block(_layer(params["blocks"], i), h)
                if return_cache:
                    for dst, src in zip(states, st):
                        dst[i].copy_(src)
            if shared:
                h, kv = _apply_attn_block(params["shared_block"], h, cfg, rc,
                                          positions, return_kv=return_cache)
                if return_cache:
                    ks.append(kv[0])
                    vs.append(kv[1])
        if return_cache:
            cache = {"ssm": states, "pos": S}
            if cfg.family == "hybrid":
                cache.update(k=torch.stack(ks), v=torch.stack(vs))
    else:
        attn_block = _maybe_remat(lambda bp, hh: _apply_attn_block(
            bp, hh, cfg, rc, positions, return_kv=return_cache), rc)
        for i in range(cfg.n_layers):
            h, kv = attn_block(_layer(params["blocks"], i), h)
            if return_cache:
                ks.append(kv[0])
                vs.append(kv[1])
        if return_cache:
            cache = {"k": torch.stack(ks), "v": torch.stack(vs), "pos": S}

    if last_only:
        h = h[:, -1:, :]
    logits = _logits(params, h, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return logits, aux, cache


# ---------------------------------------------------------------------------
# Decode (single token against a cache)
# ---------------------------------------------------------------------------
def init_cache(cfg, rc: RunConfig, batch: int, max_len: int):
    """Zeroed decode cache, the structure forward(return_cache=True) gives.

    The SSM state does not grow with the sequence: ``max_len`` sizes only
    the k/v, of every layer (dense) or of every shared-block application
    (hybrid). Each layer's state is its own zeroed allocation (no
    broadcast views), since decode writes it in place.
    """
    _require_ported(cfg)
    device = torch.device(rc.device)
    K, hd, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    kw = dict(dtype=rc.compute_dtype, device=device)
    cache = {}
    if cfg.family in ("ssm", "hybrid"):
        cache["ssm"] = ssm_lib.init_ssm_state(cfg, batch, rc.compute_dtype, device,
                                              layers=L)
    if cfg.family != "ssm":
        n_kv = (L if cfg.family == "dense"
                else sum(shared for *_, shared in _mamba_segments(cfg)))
        shape = (n_kv, batch, max_len, K, hd)
        cache.update(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw))
    cache["pos"] = 0
    return cache


def decode_step(params, cfg, rc: RunConfig, cache, tokens: torch.Tensor):
    """One decode step. tokens: (B, 1) int.

    Returns (logits (B, 1, Vp), new_cache). The cache is written in place
    (the JAX package donates it): this step's k/v into ``cache["k"]`` /
    ``cache["v"]`` (of each layer, or of each shared-block application),
    and each Mamba2 layer's new state into ``cache["ssm"]``. new_cache
    holds the same tensors and pos + 1. ``pos`` is a host int, so a step
    forces no device sync.
    """
    _require_ported(cfg)
    params = _cast_params(params, rc)
    index = int(cache["pos"])
    h = params["embed"][tokens]
    if cfg.scale_embeddings:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=rc.compute_dtype)

    positions = torch.full(tokens.shape[:1] + (1,), index, device=h.device)
    if cfg.family in ("ssm", "hybrid"):
        states = cache["ssm"]
        app = 0
        for a, b, shared in _mamba_segments(cfg):
            for i in range(a, b):
                h, st = _apply_mamba_block(_layer(params["blocks"], i), h, cfg, rc,
                                           state=ssm_lib.SSMState(*(t[i] for t in states)))
                for dst, src in zip(states, st):
                    dst[i].copy_(src)
            if shared:
                h, _ = _apply_attn_block(params["shared_block"], h, cfg, rc, positions,
                                         cache=(cache["k"][app], cache["v"][app]),
                                         cache_index=index)
                app += 1
    else:
        for i in range(cfg.n_layers):
            h, _ = _apply_attn_block(_layer(params["blocks"], i), h, cfg, rc, positions,
                                     cache=(cache["k"][i], cache["v"][i]),
                                     cache_index=index)

    new_cache = dict(cache)
    new_cache["pos"] = index + 1
    return _logits(params, h, cfg), new_cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def lm_loss(logits, labels, cfg, aux=None, aux_weight: float = 0.01):
    """Mean next-token CE over (B, S), plus ``aux_weight * aux`` when given."""
    ce = softmax_cross_entropy(logits, labels, cfg.vocab_size).mean()
    if aux is not None:
        ce = ce + aux_weight * aux
    return ce
