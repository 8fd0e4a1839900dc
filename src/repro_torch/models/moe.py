"""Mixture-of-Experts layer: routed top-k experts + shared experts.

The port of the JAX package's ``repro/models/moe.py``: GShard-style
dense dispatch and combine. Each group of tokens routes token-choice
top-k with a per-group expert capacity C; dispatch (0/1, bf16) and
combine (the gate weights, f32) are one-hot (G, S, E, C) tensors, and
the layer is four batched products around the three expert products.

Experts are padded to a multiple of 16 (``cfg.n_experts_padded``): pad
experts get a router logit of -1e9 (not -inf) before the softmax, so
top-k never picks them, and the aux loss covers the real experts only.

Top-k follows ``jax.lax.top_k``: values in descending order, a tie
going to the lower expert index. ``torch.topk`` promises no order among
ties, and the bf16 router logits tie often, so ``route`` takes the
first k of a stable descending sort instead.

The products stay ``torch.einsum`` (cuBLAS on the card), as the JAX
package leaves them to XLA outside any Pallas kernel. The one-hot
dispatch costs as much as a product: at B=8, S=512 on qwen2-moe-a2.7b
(two groups of 2048 tokens, 64 experts, C = 172, d 2048) each of
dispatch and combine is 2·G·S·Ep·C·D = 185 GFLOP a layer, against 381
GFLOP for the three expert products. A dispatch that gathers rows by
index is later work.

Under a mesh (DTensor activations) the layer runs on each rank's local
shards (``_apply_moe_local``), as the attention runs K1: each rank routes
its own groups of tokens (the batch on dp; a group that straddles the
ranks' rows has the rows gathered first) with the same ``route`` on
plain tensors, so the stable top-k and the capacity order are the
single process's; the experts stay on tp (``_MOE_AXES``: each rank runs
the dispatch, expert and combine products for its experts, the fsdp
dim gathered) and the output is Partial over tp; the aux loss is made
whole from each rank's sums over its tokens.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.layers import (RunConfig, apply_mlp, dense_init, init_mlp,
                                       uneven_rows)
from repro_torch.parallel.mesh import (from_local, grad_placements, local_offset,
                                       reduce_partial, unshard_dim)


def init_moe(gen, cfg, dtype, device):
    d, f, Ep = cfg.d_model, cfg.expert_d_ff, cfg.n_experts_padded
    p = {
        "router": dense_init(gen, (d, Ep), torch.float32, device),
        "w1": dense_init(gen, (Ep, d, f), dtype, device),
        "w3": dense_init(gen, (Ep, d, f), dtype, device),
        "w2": dense_init(gen, (Ep, f, d), dtype, device,
                         scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }
    if cfg.shared_expert_d_ff:
        p["shared"] = init_mlp(gen, d, cfg.shared_expert_d_ff, dtype, device)
    return p


def _capacity(cfg, group: int) -> int:
    """Slots per expert and group: the JAX package's float arithmetic,
    rounded up to a multiple of 4, at least 4."""
    c = int(cfg.top_k * group / cfg.n_experts * cfg.capacity_factor)
    return max(4, (c + 3) // 4 * 4)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, in
    descending order, ties to the lower index (``jax.lax.top_k``'s rule)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits_f32: torch.Tensor, cfg, group: int):
    """Top-k routing with capacity. logits: (G, S, Ep) f32.

    Returns (dispatch (G, S, Ep, C) bf16, combine (G, S, Ep, C) f32,
    aux_loss f32 scalar). A token's choice in slot j takes the next free
    place in its expert's queue, after every choice of slots < j and of
    earlier tokens in slot j; a choice past capacity is dropped.
    """
    dispatch, combine, probs = _route(logits_f32, cfg, group)
    E = cfg.n_experts
    me = probs[..., :E].mean(dim=(0, 1))
    assign = dispatch[..., :E, :].float().sum(-1).mean(dim=(0, 1))
    return dispatch, combine, _aux(me, assign, E)


def _route(logits_f32: torch.Tensor, cfg, group: int):
    """``route``'s dispatch and combine, and the router's probabilities."""
    E, Ep, k = cfg.n_experts, cfg.n_experts_padded, cfg.top_k
    C = _capacity(cfg, group)
    if Ep > E:                       # padded experts are never routable
        pad = torch.arange(Ep, device=logits_f32.device) >= E
        logits_f32 = logits_f32.masked_fill(pad, -1e9)
    probs = torch.softmax(logits_f32, dim=-1)                     # (G, S, Ep)
    gate_vals, idx = top_k(probs, k)                              # (G, S, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    G, S, _ = probs.shape
    dispatch = torch.zeros((G, S, Ep, C), dtype=torch.bfloat16, device=probs.device)
    combine = torch.zeros((G, S, Ep, C), dtype=torch.float32, device=probs.device)
    counts = torch.zeros((G, Ep), dtype=torch.int32, device=probs.device)
    for slot in range(k):
        oh = F.one_hot(idx[:, :, slot], Ep).to(torch.int32)                # (G, S, Ep)
        pos = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh + counts[:, None, :]
        keep = (pos < C) & (oh > 0)
        pos_oh = F.one_hot(torch.where(keep, pos, 0).long(), C).float()
        sel = keep.float()[..., None] * pos_oh                             # (G, S, Ep, C)
        dispatch = dispatch + sel.to(torch.bfloat16)
        combine = combine + sel * gate_vals[:, :, slot, None, None]
        counts = counts + oh.sum(dim=1, dtype=torch.int32)
    return dispatch, combine, probs


def _aux_sums(probs, dispatch, E: int):
    """The sums over the tokens of the router's probabilities and of the
    kept assignments, per real expert: (E,) each."""
    return (probs[..., :E].sum(dim=(0, 1)),
            dispatch[..., :E, :].float().sum(-1).sum(dim=(0, 1)))


def _aux(me, assign, E: int):
    """The load-balancing aux loss (Switch-style) over the real experts,
    from their mean probabilities and mean assignments."""
    return E * torch.sum(me * assign)


def apply_moe(params, x: torch.Tensor, cfg, rc: RunConfig):
    """x: (B, S, D) -> (y (B, S, D), aux_loss f32 scalar).

    The B * S tokens route in G groups of ``min(rc.moe_group, B * S)``;
    the group must divide the token count.
    """
    B, S, D = x.shape
    tokens = B * S
    group = min(rc.moe_group, tokens)
    G = tokens // group
    if G * group != tokens:
        raise ValueError(f"moe_group {group} does not divide the {tokens} tokens")
    if isinstance(x, DTensor):
        return _apply_moe_local(params, x, cfg, rc, group)
    xg = x.reshape(G, group, D)

    logits = xg @ params["router"].to(rc.compute_dtype)
    dispatch, combine, aux = route(logits.float(), cfg, group)
    y = _experts(xg, dispatch, combine, params["w1"], params["w3"], params["w2"])
    if "shared" in params:
        y = y + apply_mlp(params["shared"], xg)
    return y.reshape(B, S, D), aux


def _experts(xg, dispatch, combine, w1, w3, w2):
    """Dispatch, the three expert products and combine -> (G, S, D)."""
    xe = torch.einsum("gsec,gsd->gecd", dispatch.to(xg.dtype), xg)         # (G, E, C, D)
    h1 = F.silu(torch.einsum("gecd,edf->gecf", xe, w1))
    h3 = torch.einsum("gecd,edf->gecf", xe, w3)
    he = torch.einsum("gecf,efd->gecd", h1 * h3, w2)                       # (G, E, C, D)
    return torch.einsum("gsec,gecd->gsd", combine.to(he.dtype), he)


def _apply_moe_local(params, x: DTensor, cfg, rc: RunConfig, group: int):
    """``apply_moe`` on each rank's shards of a DTensor ``x``.

    Routing runs on plain tensors, on each rank's own groups (its rows of
    the batch; where a group would straddle two ranks' rows the rows are
    gathered and every rank routes them all), redone alike on each rank
    of the experts' mesh dims. Each rank then runs its experts' slice of
    dispatch and combine and their products (the block has gathered the
    weights' fsdp dim: ``transformer._use``), so the routed output is
    Partial on the experts' mesh dims. The gradients of x and of the
    router are Partial on the experts' mesh dims (each rank's experts
    add their share), those of the router and the experts Partial on the
    batch's. The aux loss is made whole from each rank's sums over its
    tokens, each divided by the number of ranks on the experts' mesh
    dims, which repeat them.
    """
    mesh = x.device_mesh
    B, S, D = x.shape
    x = reduce_partial(x)
    for d in (1, 2):
        x = unshard_dim(x, d)
    if (x.to_local().shape[0] * S) % group:
        x = unshard_dim(x, 0)
    ws = [params[k] for k in ("w1", "w3", "w2")]
    router = params["router"]
    # mesh dims where x is sharded (disjoint tokens) or the experts are
    tok = [isinstance(p, Shard) for p in x.placements]
    exp = [isinstance(p, Shard) for p in ws[0].placements]
    split = [Partial() if t or e else Replicate() for t, e in zip(tok, exp)]
    xl = x.to_local(grad_placements=grad_placements(x, ws[0]))
    wl = [w.to_local(grad_placements=grad_placements(w, x)) for w in ws]
    rl = router.to_local(grad_placements=split)
    Bl = xl.shape[0]
    xg = xl.reshape(Bl * S // group, group, D)

    logits = xg @ rl.to(rc.compute_dtype)
    dispatch, combine, probs = _route(logits.float(), cfg, group)
    e0, El = local_offset(ws[0], 0), wl[0].shape[0]
    y = _experts(xg, dispatch[:, :, e0:e0 + El], combine[:, :, e0:e0 + El], *wl)
    y = from_local(y.reshape(Bl, S, D), mesh,
                   [Partial() if e else p for p, e in zip(x.placements, exp)], (B, S, D))
    if uneven_rows(x):       # DTensor would gather rows cut unevenly beside a Partial
        y = reduce_partial(y)

    repeats = 1
    for i, (t, e) in enumerate(zip(tok, exp)):
        repeats *= mesh.size(i) if e and not t else 1
    whole = [Replicate()] * mesh.ndim
    me, assign = (DTensor.from_local(t / (B * S * repeats), mesh, split,
                                     run_check=False).redistribute(mesh, whole)
                  for t in _aux_sums(probs, dispatch, cfg.n_experts))
    aux = _aux(me, assign, cfg.n_experts)
    if "shared" in params:
        y = y + apply_mlp(params["shared"], x)
    return y, aux
