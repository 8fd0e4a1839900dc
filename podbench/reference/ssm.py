"""The reference of a Mamba2 stack (arXiv:2405.21060), in plain PyTorch and
float32.

``params`` is the benchmark's weight tree: ``embed`` (Vp, D),
``final_norm``, ``head`` where untied, and ``blocks`` whose leaves stack
the layers: ``ln`` (the pre-norm's scale) and ``mamba``: ``in_x``,
``in_z`` (D, Di), ``in_B``, ``in_C`` (D, G N), ``in_dt`` (D, H),
``conv_x`` (W, Di), ``conv_B``, ``conv_C`` (W, G N) (and ``conv_x_bias``,
``conv_B_bias``, ``conv_C_bias`` where the conv has a bias), ``A_log``,
``dt_bias``, ``D_skip`` (H,), ``gate_norm`` (Di,) and ``out`` (Di, D).
Di = ssm_expand D; H = Di / P heads of P = ssm_head_dim; G = ssm_groups
(1 where the configuration gives none) groups of N = ssm_state, head h
reading group h // (H / G), as the published block groups its heads.

A layer, as the published Mamba2 block computes it:

    x, z, B, C, dt = the projections of rms_norm(h)
    x, B, C = silu(depthwise causal conv(.) + bias), each channel alone
    dt = softplus(dt + dt_bias);  A = -exp(A_log)
    y = SSD(x, dt, A, B, C) + D_skip x                     per head
    h = h + out(rms_norm(y * silu(z)))                     over each group's Di / G channels

The SSD is section 6's chunked algorithm at the ``reference`` section's
``ssd_block`` (``ssd``): within a block the masked quadratic form, then
each block's own final state, carried from block to block (decayed over
each block), and the carried state's share of the next block's outputs.
A prefill hands decode each layer's final SSD state and the last W - 1
rows of the x, B and C projections (before the conv).

Departures from the published block, each as the program lays the layer
out and none of them a change of the function:

- x, z, B, C and dt are five projections, not one ``in_proj`` cut in five;
- the conv is three depthwise convs over x, B and C, not one over their
  concatenation (a depthwise conv treats each channel alone);
- norm scales are stored as offsets from 1 (the scale is 1 + g);
- both norms take the configuration's ``norm_eps``;
- no clamp of dt (the published default limit is (0, inf)).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from podbench.reference import common

CACHE = ("ssm/ssd", "ssm/conv_x", "ssm/conv_B", "ssm/conv_C")


def ssd(x, dt, A, B, C, block: int, mm, init=None):
    """Section 6's chunked SSD. x (b, s, h, p); dt (b, s, h), the step
    after softplus; A (h,), negative; B, C (b, s, g, n); ``init`` (b, h, p,
    n) or None. Returns y (b, s, h, p) and the final state (b, h, p, n).
    The products go through ``mm``; the decays and the carry from block to
    block are elementwise."""
    b, s, h, p = x.shape
    g, n = B.shape[-2:]
    q = h // g                                                   # heads a group
    L = min(block, s)
    if s % L:
        raise ValueError(f"the SSD block {L} does not divide the sequence length {s}")
    c = s // L
    cum = (dt * A).reshape(b, c, L, g, q).permute(0, 1, 3, 4, 2).cumsum(-1)   # (b,c,g,q,L)
    X = (x * dt[..., None]).reshape(b, c, L, g, q, p).permute(0, 1, 3, 4, 2, 5)
    Bc = B.reshape(b, c, L, g, n).transpose(2, 3)                # (b, c, g, L, n)
    Cc = C.reshape(b, c, L, g, n).transpose(2, 3)

    # 1. within a block: y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    live = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~live, -math.inf))
    y = mm(mm(Cc, Bc.transpose(-1, -2))[:, :, :, None] * decay, X)   # (b,c,g,q,L,p)
    del decay

    # 2. each block's own state at its end: sum_j exp(cum_end - cum_j) dt_j x_j B_j^T
    to_end = torch.exp(cum[..., -1:] - cum)
    Xe = (X * to_end[..., None]).transpose(-1, -2).reshape(b, c, g, q * p, L)
    own = mm(Xe, Bc).reshape(b, c, g, q, p, n)

    # 3. the state entering each block: the last one decayed over its block, plus its own
    whole = torch.exp(cum[..., -1])                              # (b, c, g, q)
    st = (x.new_zeros(b, g, q, p, n) if init is None
          else init.float().reshape(b, g, q, p, n))
    entering = []
    for k in range(c):
        entering.append(st)
        st = st * whole[:, k, ..., None, None] + own[:, k]

    # 4. the entering state's share of each output: exp(cum_i) C_i . state
    held = torch.stack(entering, 1).reshape(b, c, g, q * p, n)
    y_in = mm(Cc, held.transpose(-1, -2)).reshape(b, c, g, L, q, p).transpose(3, 4)
    y = y + y_in * torch.exp(cum)[..., None]
    return y.permute(0, 1, 4, 2, 3, 5).reshape(b, s, h, p), st.reshape(b, h, p, n)


def conv(u, w, bias=None):
    """Depthwise causal conv of u (B, S, C) with w (W, C), zero before the
    first position: (y, the last W - 1 rows of the zero-padded u, the tail
    decode continues from)."""
    W, S = w.shape[0], u.shape[1]
    pad = torch.cat([u.new_zeros(u.shape[0], W - 1, u.shape[2]), u], 1)
    y = sum(pad[:, k:k + S] * w[k].float() for k in range(W))
    if bias is not None:
        y = y + bias.float()
    return y, pad[:, S:]


def gated_norm(y, z, scale, groups: int, eps: float):
    """rms_norm(y * silu(z)) over each group's channels, times (1 + scale)."""
    g = y * F.silu(z)
    B, S, Di = g.shape
    g = g.reshape(B, S, groups, Di // groups)
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps)
    return g.reshape(B, S, Di) * (1.0 + scale.float())


def mixer(p, x, arch, mm, run):
    """The Mamba2 mixer on ``x`` = rms_norm(h) (B, S, D): its output (B, S,
    D) and what it hands to decode (the final SSD state, the x, B and C
    conv tails)."""
    G, P, N = arch.get("ssm_groups", 1), arch["ssm_head_dim"], arch["ssm_state"]
    b, s, _ = x.shape
    xs, z, dt = mm(x, p["in_x"]), mm(x, p["in_z"]), mm(x, p["in_dt"])
    act, tails = {}, {}
    for name, u in (("x", xs), ("B", mm(x, p["in_B"])), ("C", mm(x, p["in_C"]))):
        y, tails[name] = conv(u, p["conv_" + name], p.get(f"conv_{name}_bias"))
        act[name] = F.silu(y)
    H = xs.shape[-1] // P
    xh = act["x"].reshape(b, s, H, P)
    y, state = ssd(xh, F.softplus(dt + p["dt_bias"].float()), -torch.exp(p["A_log"].float()),
                   act["B"].reshape(b, s, G, N), act["C"].reshape(b, s, G, N),
                   run["ssd_block"], mm)
    y = y + p["D_skip"].float()[:, None] * xh
    y = gated_norm(y.reshape(b, s, H * P), z, p["gate_norm"], G, arch["norm_eps"])
    return mm(y, p["out"]), (state, tails["x"], tails["B"], tails["C"])


def layer(bp, h, arch, mm, run):
    """One Mamba2 layer: (h + mixer(rms_norm(h)), what it hands to decode)."""
    y, state = mixer(bp["mamba"], common.rms_norm(h, bp["ln"], arch["norm_eps"]), arch, mm, run)
    return h + y, state


def apply(bp, h, arch, mm, run, remat: bool, states):
    """``layer``, checkpointed under ``remat``; its state appended to
    ``states`` where that is a list."""
    if remat:
        return checkpoint(lambda x: layer(bp, x, arch, mm, run)[0], h, use_reentrant=False)
    h, state = layer(bp, h, arch, mm, run)
    if states is not None:
        states.append(state)
    return h


def stacked(states) -> dict:
    """The layers' states as the cache's leaves, stacked by layer."""
    return {name: torch.stack(t) for name, t in zip(CACHE, zip(*states))}


def hidden(params, arch, tokens, mm, run: dict, *, remat: bool = False, states=None):
    """The residual stream after the last layer, (B, S, D) float32."""
    h = params["embed"][tokens.long()].float()
    for bp in common.layers(params["blocks"], arch["n_layers"]):
        h = apply(bp, h, arch, mm, run, remat, states)
    return h


def prefill(params, arch, tokens, mm, run: dict):
    """(the last layer's output, the cache: ``CACHE``'s leaves)."""
    states = []
    h = hidden(params, arch, tokens, mm, run, states=states)
    return h, stacked(states)
