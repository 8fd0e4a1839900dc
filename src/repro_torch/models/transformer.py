"""Model assembly: stacked blocks, forward, decode, one code path per family.

  dense / moe / audio : homogeneous attention-block stack
  ssm                 : homogeneous Mamba2 stack
  hybrid (zamba2)     : Mamba2 stack in segments, ONE shared attn+MLP
                        block applied after every ``attn_every`` layers
  vlm (llama3.2-V)    : self-attention stack in segments, a gated
                        cross-attention block after every
                        ``cross_attn_every`` layers

Params keep the JAX package's tree: a dict with ``embed``,
``final_norm`` and ``blocks``, whose leaves are stacked with a leading
L axis (plus the hybrid's unstacked ``shared_block`` and the vlm's
``cross_blocks``, stacked over L // cross_attn_every). The JAX
package's ``lax.scan`` over layers becomes a Python loop over that
axis. A moe block holds ``moe`` (``models/moe.py``) where a dense one
holds ``mlp``, and adds its aux loss to the forward's; the audio family
takes frame embeddings (``embeds``) in place of tokens; a cross block
has no MLP and adds ``tanh(gate) * attention(image)``. A segment shorter
than its period (the hybrid's 38 = 6 * 6 + 2) gets no block after it.

With ``RunConfig.remat`` each layer's block is checkpointed under a
gradient (``_maybe_remat``), as the JAX package wraps its scan bodies;
the hybrid's shared block is not, as in the JAX package.

Under a mesh, ``RunConfig.constrain`` places the residual stream where
the JAX package constrains it: batch on dp after the embedding, at each
block's exit (and after the attention with ``attn_exit_constrain``),
sequence-sharded on tp between blocks with ``seq_shard_carry``
(gathered at each block's entry), and the logits' vocab on tp. Each
block gathers its own layer's weights over the FSDP mesh dims where it
runs (``_use``: inside the checkpoint under remat), so each layer's
gradient is reduce-scattered there, as XLA does inside the JAX package's
layer scan; a checkpointed block saves its rank's cut of the carry
(``_maybe_remat``); the embedding lookup reads each rank's vocab rows
(``layers.vocab_sharded_lookup``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (RunConfig, apply_mlp, embed_init, init_mlp,
                                       linear, rms_norm, softmax_cross_entropy,
                                       spread_logits, uneven_rows, vocab_sharded_lookup)
from repro_torch.parallel.mesh import unbind, unshard_dim

# SSM / router leaves that stay f32 through compute-dtype casting
_KEEP_F32 = ("A_log", "dt_bias", "D_skip", "router", "gate")

# the families whose blocks are one homogeneous attention stack
_ATTN_STACK = ("dense", "moe", "audio", "vlm")
_FAMILIES = _ATTN_STACK + ("ssm", "hybrid")


def _require_family(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(cfg.family)


# the leaves a block casts and gathers itself, layer by layer (``_use``)
_BLOCK_KEYS = ("blocks", "cross_blocks", "shared_block")


def _cast(name: str, leaf, rc: RunConfig):
    """``leaf`` in the compute dtype, unless its own key contains one of
    ``_KEEP_F32`` (a substring match, as in the JAX package); a dict leaf by
    leaf. Norm scales are cast too, so bf16 compute rounds them. A leaf
    already in the compute dtype is returned as it is."""
    if isinstance(leaf, dict):
        return {k: _cast(k, v, rc) for k, v in leaf.items()}
    if (leaf.dtype == rc.compute_dtype or not leaf.is_floating_point()
            or any(k in name for k in _KEEP_F32)):
        return leaf
    return leaf.to(rc.compute_dtype)


def _cast_params(params, rc: RunConfig):
    """``_cast`` of every leaf outside the blocks (the embedding, head and
    final norm). Under a gradient the blocks' leaves are left to ``_use``,
    each layer cast where its block runs; without one (serving) they are
    cast whole here, one cast a leaf rather than one a layer, and ``_use``'s
    cast finds them done."""
    whole = not torch.is_grad_enabled()
    return {k: v if k in _BLOCK_KEYS and not whole else _cast(k, v, rc)
            for k, v in params.items()}


def _use(name: str, leaf, rc: RunConfig):
    """One layer's (or an unstacked block's) params as its products take them:
    gathered over their FSDP mesh dims (``rc.fsdp_gather``: the tp dim stays
    sharded), then cast (``_cast``). The gather's backward reduce-scatters
    the layer's gradient into its param's placements, as FSDP does, so no
    rank holds a whole layer's gradient; both run in the param's dtype (f32
    in training), as the JAX package's HLO gathers the weights and reduces
    their gradients. Under remat it runs inside the checkpoint: a gathered
    weight is never saved for the backward. Params already used are
    returned as they are (both steps are no-ops)."""
    if isinstance(leaf, dict):
        return {k: _use(k, v, rc) for k, v in leaf.items()}
    return _cast(name, rc.fsdp_gather(leaf), rc)


def _layers(tree, n: int) -> list:
    """The ``n`` layers of a stacked params tree: each leaf unbound once
    (``parallel.mesh.unbind``), so the backward stacks the layers' gradients
    into one buffer a leaf, where a select a layer would write a zeroed stack
    each."""
    cols = {k: _layers(v, n) if isinstance(v, dict) else unbind(v) for k, v in tree.items()}
    return [{k: v[i] for k, v in cols.items()} for i in range(n)]


def _segments(n_layers: int, every: int):
    """[(a, b, apply_special_after), ...] covering n_layers in runs of
    ``every`` (the JAX package's): only a full run is followed by the
    hybrid's shared block or the vlm's cross block, so a shorter last run
    (38 = 6 * 6 + 2) gets none."""
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
def _init_attn_block(gen, cfg, dtype, device, use_moe: bool = False):
    p = {
        "ln1": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        "attn": attn_lib.init_attention(gen, cfg, dtype, device),
        "ln2": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    if use_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def _init_mamba_block(gen, cfg, dtype, device):
    return {
        "ln": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        "mamba": ssm_lib.init_mamba(gen, cfg, dtype, device),
    }


def _init_cross_block(gen, cfg, dtype, device):
    return {
        "ln": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        "attn": attn_lib.init_attention(gen, cfg, dtype, device, cross=True),
        "gate": torch.zeros((), dtype=torch.float32, device=device),
    }


def _stack(trees):
    """One tree whose leaves stack ``trees``' along a new leading axis.

    ``trees`` are emptied as they are stacked: each leaf's layers are
    released as soon as their stack exists, so the peak is the stacked
    tree plus one leaf's layers, not two copies of the tree (30 GB of
    qwen2-moe-a2.7b's experts in bf16).
    """
    out = {}
    for k in list(trees[0]):
        vals = [t.pop(k) for t in trees]
        out[k] = _stack(vals) if isinstance(vals[0], dict) else torch.stack(vals)
        del vals
    return out


def init_params(cfg, gen: Optional[torch.Generator], rc: RunConfig) -> Dict[str, Any]:
    """Random params with the JAX package's distributions, on ``rc.device``.

    truncated-normal fan-in matrices (``wo``, the experts' ``w2`` and
    the Mamba2 ``out`` scaled by 1/sqrt(2L)), embeddings N(0, 0.02),
    zero biases, norms and cross-block gates, and the Mamba2 leaves of
    ``ssm.init_mamba``. ``gen`` must live on ``rc.device``; it may be
    None only on the meta device.
    """
    _require_family(cfg)
    dtype, device = rc.param_dtype, torch.device(rc.device)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_padded, cfg.d_model), dtype, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, (cfg.vocab_padded, cfg.d_model), dtype, device)
    if cfg.family in _ATTN_STACK:
        use_moe = cfg.family == "moe"
        params["blocks"] = _stack([_init_attn_block(gen, cfg, dtype, device, use_moe)
                                   for _ in range(cfg.n_layers)])
    else:
        params["blocks"] = _stack([_init_mamba_block(gen, cfg, dtype, device)
                                   for _ in range(cfg.n_layers)])
    if cfg.family == "hybrid":
        params["shared_block"] = _init_attn_block(gen, cfg, dtype, device)
    if cfg.family == "vlm":
        params["cross_blocks"] = _stack([_init_cross_block(gen, cfg, dtype, device)
                                         for _ in range(_n_cross(cfg))])
    return params


def _n_cross(cfg) -> int:
    return cfg.n_layers // cfg.cross_attn_every


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _carry_axes(rc: RunConfig):
    # Megatron-SP: the residual stream parks sequence-sharded on 'tp'
    # between blocks (the axis is idle there).
    return ("dp", "tp", None) if rc.seq_shard_carry else ("dp", None, None)


def _enter(x, rc: RunConfig):
    """SP block entry: ONE all-gather of the post-norm activations."""
    if rc.seq_shard_carry:
        return rc.constrain(x, ("dp", None, None))
    return x


def _residual_add(h, delta, rc: RunConfig, block_exit: bool = False):
    """SP: reduce-scatter the block output into the sharded carry.
    Without SP, constrain only at the block exit, or also after the
    attention with ``attn_exit_constrain`` (the JAX package's)."""
    if rc.seq_shard_carry:
        delta = rc.constrain(delta, _carry_axes(rc))
        return rc.constrain(h + delta, _carry_axes(rc))
    if block_exit or rc.attn_exit_constrain:
        return rc.constrain(h + delta, _carry_axes(rc))
    return h + delta


def _apply_attn_block(bp, h, cfg, rc, positions, *, cache=None, cache_index=None,
                      return_kv=False):
    """-> (h, kv, aux): aux is the MoE's aux loss, None for an MLP block."""
    bp = _use("", bp, rc)
    x1 = _enter(rms_norm(h, bp["ln1"], cfg.norm_eps), rc)
    a, kv = attn_lib.apply_attention(
        bp["attn"], x1, cfg, rc, positions,
        cache=cache, cache_index=cache_index, return_kv=return_kv)
    h = _residual_add(h, a, rc)
    x2 = _enter(rms_norm(h, bp["ln2"], cfg.norm_eps), rc)
    aux = None
    if "moe" in bp:
        m, aux = moe_lib.apply_moe(bp["moe"], x2, cfg, rc)
    else:
        m = apply_mlp(bp["mlp"], x2, gelu=cfg.gelu_mlp)
    return _residual_add(h, m, rc, block_exit=True), kv, aux


def _apply_mamba_block(bp, h, cfg, rc, *, state=None, return_state=False):
    bp = _use("", bp, rc)
    x1 = _enter(rms_norm(h, bp["ln"], cfg.norm_eps), rc)
    y, new_state = ssm_lib.apply_mamba(bp["mamba"], x1, cfg, rc, state=state,
                                       return_state=return_state)
    return _residual_add(h, y, rc, block_exit=True), new_state


def _apply_cross_block(bp, h, cfg, rc, img_embeds, *, cache=None):
    """Gated cross-attention to the image: no MLP, no RoPE, not causal.
    ``img_embeds`` (B, N, D) in prefill, or the cached (xk, xv) in decode."""
    bp = _use("", bp, rc)
    a, kv = attn_lib.apply_attention(
        bp["attn"], rms_norm(h, bp["ln"], cfg.norm_eps), cfg, rc, None,
        kv_x=img_embeds, causal=False, cache=cache, return_kv=True, is_cross=True)
    return h + torch.tanh(bp["gate"]).to(h.dtype) * a, kv


# what ``remat_policy="dots"`` saves: the outputs of the matmuls, as
# ``jax.checkpoint_policies.checkpoint_dots`` saves those of dot_general
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


# where a checkpointed block's input, the carry it saves, is kept: its
# sequence cut over tp, each rank its own part, as XLA keeps the saved
# carries of the JAX package's rematted scan
_SAVED_CARRY = ("dp", "tp", None)


def _maybe_remat(fn, rc: RunConfig):
    """``fn(bp, h)`` checkpointed as the JAX package's ``_maybe_remat`` does.

    ``remat`` off: ``fn`` itself. ``remat_policy="dots"``: a selective
    checkpoint that saves the matmul outputs (``_DOTS``) and recomputes
    the rest. Any other policy: a plain checkpoint that recomputes all of
    ``fn`` in the backward (``jax.checkpoint(fn)``). Without grad mode
    ``fn`` runs as it is: there is no backward to recompute for.

    On a mesh the carry ``h`` that the checkpoint saves is first cut to
    ``_SAVED_CARRY`` and put back in the carry's placements inside the
    recomputed block (an all-gather over tp), so each rank saves its own
    cut of each layer's residual, not the whole; ``bp``, the layer's f32
    shards, is cast and gathered inside ``fn`` (``_use``). Without a mesh
    both constrains are the identity.
    """
    if not rc.remat:
        return fn
    kw = {"use_reentrant": False}
    if rc.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             list(_DOTS))

    def block(bp, h):
        return fn(bp, rc.constrain(h, _carry_axes(rc)))

    def remat(bp, h):
        if not torch.is_grad_enabled():
            return fn(bp, h)
        return checkpoint(block, bp, rc.constrain(h, _SAVED_CARRY), **kw)
    return remat


def _logits(params, h, cfg, rc: Optional[RunConfig] = None, vocab_pieces: bool = False):
    """The head's product on the final-normed ``h``, softcapped where the
    config says, and given ``rc`` constrained to rows on dp, vocab on tp.

    On DTensors the product is placed here. Where h's rows and the head's
    D (its FSDP dim) share a mesh dim, the head's D is gathered, so each
    rank multiplies its own rows by its vocab shard: left to itself,
    DTensor may gather the rows instead where a rank holds few (2 a rank:
    the micro-batch's whole logits on every rank). Where h's rows are cut
    unevenly (a micro-batch of fewer rows than dp ranks, some ranks
    holding none), every rank takes all the rows against its own piece of
    the vocab, cut model-major (``layers.spread_logits``): the product and
    the loss are then shared by all ranks, not left to the ranks that hold
    a row. Those logits come back as ``VocabPieces`` where the caller asks
    for them (``vocab_pieces``: the loss), else gathered into each vocab
    slice of the head. Either way the head's gradient comes back in its
    placements.
    """
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    if uneven_rows(h) and isinstance(head, DTensor):
        pieces = spread_logits(h, head)
        pieces = pieces._replace(local=_softcap(pieces.local, cfg))
        return pieces if vocab_pieces else pieces.to_dtensor()
    if isinstance(h, DTensor) and isinstance(head, DTensor) and any(
            hp == Shard(0) and wp == Shard(1)
            for hp, wp in zip(h.placements, head.placements)):
        head = unshard_dim(head, 1)
    logits = _softcap(linear(h, head.T), cfg)
    if rc is None:
        return logits
    return rc.constrain(logits, ("dp", None, "tp"))


def _softcap(logits, cfg):
    if cfg.logit_softcap:
        return torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------
def _lookup(table, tokens):
    """``table[tokens]``; on a DTensor table each rank reads the rows of its
    own vocab shard (``layers.vocab_sharded_lookup``): no rank gathers the
    table, and its gradient comes back in the table's placements."""
    if not isinstance(table, DTensor):
        return table[tokens]
    return vocab_sharded_lookup(table, tokens)


def _embed(params, cfg, rc: RunConfig, tokens, embeds):
    """The residual stream's input: ``embeds`` (B, S, D) cast to the compute
    dtype (audio frames), else the embedding rows of ``tokens`` (B, S)."""
    h = embeds.to(rc.compute_dtype) if embeds is not None else _lookup(params["embed"], tokens)
    if cfg.scale_embeddings:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=rc.compute_dtype)
    return h


def forward(params, cfg, rc: RunConfig, *, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            img_embeds: Optional[torch.Tensor] = None,
            return_cache: bool = False, last_only: bool = False,
            vocab_pieces: bool = False):
    """Full-sequence forward over tokens (B, S), or frame embeddings
    ``embeds`` (B, S, D) for the audio family; a vlm also takes
    ``img_embeds`` (B, N, D), and without them runs its self-attention
    stack alone, as the JAX package does.

    Returns (logits, aux_loss, cache). aux_loss is the f32 sum of the
    MoE layers' aux losses (0 for the other families). The cache is None
    unless ``return_cache`` (prefill); then it is {"k", "v": (L, B, S, K,
    hd), "pos": S} for the attention stacks, plus the cross blocks'
    "xk", "xv": (L // cross_attn_every, B, N, K, hd) for a vlm given an
    image; {"ssm": SSMState stacked over L, "pos": S} for the ssm family,
    and for the hybrid that state plus the shared block's "k", "v":
    (n_apps, B, S, K, hd), one per application; ``pos`` is a host int.
    ``last_only`` emits logits for the final position only (what serving
    prefill needs). ``vocab_pieces``: on rows cut unevenly over a mesh the
    logits come back as each rank's ``layers.VocabPieces``, which only the
    loss reads (``_logits``).
    """
    _require_family(cfg)
    params = _cast_params(params, rc)
    h = rc.constrain(_embed(params, cfg, rc, tokens, embeds), ("dp", None, None))
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    if cfg.family in ("ssm", "hybrid"):
        h, cache = _mamba_forward(params, cfg, rc, h, positions, return_cache)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    else:
        img = img_embeds if cfg.family == "vlm" else None
        h, cache, aux = _attn_forward(params, cfg, rc, h, positions, img, return_cache)
    if return_cache:
        cache["pos"] = S
    if last_only:
        h = h[:, -1:, :]
    return _logits(params, h, cfg, rc, vocab_pieces), aux, cache


def _attn_forward(params, cfg, rc, h, positions, img, return_cache):
    """The attention stack (dense, moe, audio, vlm) -> (h, cache, aux).

    With ``img`` (a vlm's image), a cross block follows every full
    segment of ``cross_attn_every`` layers."""
    attn_block = _maybe_remat(lambda bp, hh: _apply_attn_block(
        bp, hh, cfg, rc, positions, return_kv=return_cache), rc)
    segs = ([(0, cfg.n_layers, False)] if img is None
            else _segments(cfg.n_layers, cfg.cross_attn_every))
    if img is not None:
        img = img.to(rc.compute_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    blocks = _layers(params["blocks"], cfg.n_layers)
    cross_blocks = _layers(params["cross_blocks"], _n_cross(cfg)) if img is not None else []
    ks, vs, xks, xvs = [], [], [], []
    ci = 0
    for a, b, cross in segs:
        for i in range(a, b):
            h, kv, layer_aux = attn_block(blocks[i], h)
            if layer_aux is not None:
                aux = aux + layer_aux
            if return_cache:
                ks.append(kv[0])
                vs.append(kv[1])
        if cross:
            h, xkv = _apply_cross_block(cross_blocks[ci], h, cfg, rc, img)
            if return_cache:
                xks.append(xkv[0])
                xvs.append(xkv[1])
            ci += 1
    cache = None
    if return_cache:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if img is not None:
            cache.update(xk=torch.stack(xks), xv=torch.stack(xvs))
    return h, cache, aux


def _mamba_forward(params, cfg, rc, h, positions, return_cache):
    """The Mamba2 stack (ssm), with the shared block after every full
    segment (hybrid) -> (h, cache)."""
    mamba_block = _maybe_remat(lambda bp, hh: _apply_mamba_block(
        bp, hh, cfg, rc, return_state=return_cache), rc)
    blocks = _layers(params["blocks"], cfg.n_layers)
    # the shared block is cast (and gathered) once: its applications'
    # gradients sum in the compute dtype, as on the one cast in the JAX package
    shared_block = _use("", params["shared_block"], rc) if cfg.family == "hybrid" else None
    ks, vs, states = [], [], []
    for a, b, shared in _mamba_segments(cfg):
        for i in range(a, b):
            h, st = mamba_block(blocks[i], h)
            if return_cache:
                states.append(st)
        if shared:
            h, kv, _ = _apply_attn_block(shared_block, h, cfg, rc,
                                         positions, return_kv=return_cache)
            if return_cache:
                ks.append(kv[0])
                vs.append(kv[1])
    cache = None
    if return_cache:
        cache = {"ssm": ssm_lib.SSMState(*(torch.stack(t) for t in zip(*states)))}
        if cfg.family == "hybrid":
            cache.update(k=torch.stack(ks), v=torch.stack(vs))
    return h, cache


# ---------------------------------------------------------------------------
# Decode (single token against a cache)
# ---------------------------------------------------------------------------
def init_cache(cfg, rc: RunConfig, batch: int, max_len: int):
    """Zeroed decode cache, the structure forward(return_cache=True) gives.

    The SSM state does not grow with the sequence: ``max_len`` sizes only
    the k/v, of every layer (attention stacks) or of every shared-block
    application (hybrid). A vlm's cache adds the cross blocks' "xk" and
    "xv", sized by ``n_img_tokens``. Each layer's state is its own zeroed
    allocation (no broadcast views), since decode writes it in place.
    """
    _require_family(cfg)
    device = torch.device(rc.device)
    K, hd, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    kw = dict(dtype=rc.compute_dtype, device=device)
    cache = {}
    if cfg.family in ("ssm", "hybrid"):
        cache["ssm"] = ssm_lib.init_ssm_state(cfg, batch, rc.compute_dtype, device,
                                              layers=L)
    if cfg.family != "ssm":
        n_kv = (sum(shared for *_, shared in _mamba_segments(cfg))
                if cfg.family == "hybrid" else L)
        shape = (n_kv, batch, max_len, K, hd)
        cache.update(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw))
    if cfg.family == "vlm":
        shape = (_n_cross(cfg), batch, cfg.n_img_tokens, K, hd)
        cache.update(xk=torch.zeros(shape, **kw), xv=torch.zeros(shape, **kw))
    cache["pos"] = 0
    return cache


def decode_step(params, cfg, rc: RunConfig, cache, tokens: Optional[torch.Tensor], *,
                embeds: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B, 1) int, or embeds (B, 1, D) for audio.

    Returns (logits (B, 1, Vp), new_cache). The cache is written in place
    (the JAX package donates it): this step's k/v into ``cache["k"]`` /
    ``cache["v"]`` (of each layer, or of each shared-block application),
    and each Mamba2 layer's new state into ``cache["ssm"]``; a vlm's
    cross blocks read ``cache["xk"]`` / ``cache["xv"]`` and write
    nothing. new_cache holds the same tensors and pos + 1. ``pos`` is a
    host int, so a step forces no device sync.
    """
    _require_family(cfg)
    params = _cast_params(params, rc)
    index = int(cache["pos"])
    h = _embed(params, cfg, rc, tokens, embeds)

    positions = torch.full((h.shape[0], 1), index, device=h.device)
    blocks = _layers(params["blocks"], cfg.n_layers)
    if cfg.family in ("ssm", "hybrid"):
        shared_block = _use("", params["shared_block"], rc) if cfg.family == "hybrid" else None
        states = cache["ssm"]
        app = 0
        for a, b, shared in _mamba_segments(cfg):
            for i in range(a, b):
                h, st = _apply_mamba_block(blocks[i], h, cfg, rc,
                                           state=ssm_lib.SSMState(*(t[i] for t in states)))
                for dst, src in zip(states, st):
                    ssm_lib.write_layer(dst, i, src)
            if shared:
                h, _, _ = _apply_attn_block(shared_block, h, cfg, rc, positions,
                                            cache=(cache["k"][app], cache["v"][app]),
                                            cache_index=index)
                app += 1
    else:
        segs = (_segments(cfg.n_layers, cfg.cross_attn_every) if cfg.family == "vlm"
                else [(0, cfg.n_layers, False)])
        cross_blocks = (_layers(params["cross_blocks"], _n_cross(cfg))
                        if cfg.family == "vlm" else [])
        ci = 0
        for a, b, cross in segs:
            for i in range(a, b):
                h, _, _ = _apply_attn_block(blocks[i], h, cfg, rc,
                                            positions, cache=(cache["k"][i], cache["v"][i]),
                                            cache_index=index)
            if cross:
                h, _ = _apply_cross_block(cross_blocks[ci], h, cfg, rc,
                                          None, cache=(cache["xk"][ci], cache["xv"][ci]))
                ci += 1

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
