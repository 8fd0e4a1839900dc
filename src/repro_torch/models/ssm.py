"""Mamba2 (SSD, state-space duality) blocks.

The chunked SSD algorithm of arXiv:2405.21060 section 6:
  * intra-chunk (quadratic-in-chunk "attention-like" term)
  * chunk boundary states + inter-chunk linear recurrence
  * O(1)-state single-token decode

Projections are separate tensors (x, z, B, C, dt), as in the JAX
package. A depthwise causal conv (width 4) precedes x/B/C; with
n_groups = 1, B and C are shared across SSD heads.

``apply_mamba`` sends every multi-token scan (prefill, training, and a
chunk that continues a state) through ``kernels.ops.ssd``: kernel K2 on
a CUDA tensor, at ``pick_chunk``'s chunk cut to K2's limit
(``ssd_scan.kernel_chunk``), and ``ssd_chunked`` below at
``pick_chunk``'s chunk on a CPU tensor. Under a gradient the CUDA scan
still runs K2 (``ssd_scan.SSDScanFn``), and its backward is the autograd
of ``ssd_chunked`` recomputed in tensor ops; the train cells' chunk is
``RunConfig(ssd_chunk=32)``. The single-token decode step, the conv and
the projections stay plain PyTorch, as the JAX package computes them
outside any Pallas kernel too.

Under a mesh the activations are DTensors: the x/z/dt projections' SSD
heads sit on tp (``in_x``, ``in_z`` and ``in_dt`` are column-parallel),
B and C are whole on tp (``in_B``/``in_C`` are fsdp-only), batch on dp.
``_local_ssd`` runs the scan (K2 on the card) on each rank's local heads
and ``_local_decode_step`` the decode update, as
``attention._local_attention`` runs K1; the conv's zero tail takes the
activation's placements, and the decode's state and tails are written
into each rank's shard of the cache (``write_layer``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops, ssd_scan
from repro_torch.models.layers import RunConfig, dense_init, linear, rms_norm
from repro_torch.parallel.mesh import (from_local, grad_placements, local_offset,
                                       merge_heads, moved_placements, split_heads)


class SSMState(NamedTuple):
    """Decode-time recurrent state for one Mamba2 layer (stackable)."""

    ssd: torch.Tensor      # (B, H, P, N) f32
    conv_x: torch.Tensor   # (B, W-1, d_inner)
    conv_B: torch.Tensor   # (B, W-1, N)
    conv_C: torch.Tensor   # (B, W-1, N)


def init_mamba(gen, cfg, dtype, device):
    """One layer's params with the JAX package's distributions."""
    d, di, N, H, W = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state,
                      cfg.ssm_n_heads, cfg.ssm_conv_width)
    f32 = dict(dtype=torch.float32, device=device)
    # dt bias initialised so softplus(dt_bias) spans [1e-3, 1e-1] (mamba2 default)
    u = torch.empty((H,), **f32).uniform_(0.0, 1.0, generator=gen)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))          # inverse softplus
    conv_x = torch.empty((W, di), **f32).normal_(0.0, 1.0, generator=gen) * 0.1
    return {
        "in_x": dense_init(gen, (d, di), dtype, device),
        "in_z": dense_init(gen, (d, di), dtype, device),
        "in_B": dense_init(gen, (d, N), dtype, device),
        "in_C": dense_init(gen, (d, N), dtype, device),
        "in_dt": dense_init(gen, (d, H), dtype, device),
        "conv_x": conv_x.to(dtype),
        "conv_B": torch.full((W, N), 1.0 / W, dtype=dtype, device=device),
        "conv_C": torch.full((W, N), 1.0 / W, dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, **f32)),
        "dt_bias": dt_bias,
        "D_skip": torch.ones((H,), **f32),
        "gate_norm": torch.zeros((di,), dtype=dtype, device=device),
        "out": dense_init(gen, (di, d), dtype, device,
                          scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def causal_conv(x, w, tail=None):
    """Depthwise causal conv. x: (B, S, C), w: (W, C), tail: (B, W-1, C) or None.

    Returns (y, new_tail). W shifted adds in x's dtype, summed in the
    JAX package's order ((t0 + t1) + t2) + t3, so bf16 rounds where it
    rounds there. ``new_tail`` is a copy, not a view that would keep the
    whole padded sequence alive.
    """
    W = w.shape[0]
    if tail is None:
        tail = _zeros_like_rows(x, W - 1)
    elif isinstance(x, DTensor):
        # a cache's tail may be sharded where x is not (conv_B / conv_C on tp)
        tail = tail.redistribute(x.device_mesh, x.placements)
    xp = torch.cat([tail, x], dim=1)                  # (B, S+W-1, C)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i]
    return y, xp[:, S:].clone()


def _zeros_like_rows(x, rows: int):
    """Zeros of x's shape with ``rows`` in place of dim 1, in x's dtype,
    device and (a DTensor) placements: each rank makes its own shard."""
    if not isinstance(x, DTensor):
        return torch.zeros((x.shape[0], rows) + tuple(x.shape[2:]), dtype=x.dtype,
                           device=x.device)
    local = x.to_local()                    # the projections are never sequence-sharded
    zeros = torch.zeros((local.shape[0], rows) + tuple(local.shape[2:]), dtype=x.dtype,
                        device=local.device)
    return from_local(zeros, x.device_mesh, x.placements,
                      (x.shape[0], rows) + tuple(x.shape[2:]))


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan (the plain version of K2 on the CPU).

    xh: (B, S, H, P) inputs per head; dt: (B, S, H) post-softplus step
    sizes; A: (H,) negative decay rates; Bm/Cm: (B, S, N) input/output
    maps. Returns (y: (B, S, H, P) in xh's dtype, final_state: (B, H, P, N) f32).
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    if chunk < 1 or nc * chunk != S:
        raise ValueError(f"chunk {chunk} does not divide the sequence length {S}")
    f32 = torch.float32

    dA = dt.to(f32) * A.to(f32)                                 # (B,S,H) log-decay
    cum = torch.cumsum(dA.reshape(Bsz, nc, chunk, H), dim=2)    # (B,nc,c,H)
    xc = xh.reshape(Bsz, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, chunk, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, chunk, N).to(f32)

    # ---- intra-chunk (diagonal blocks), in head blocks of hb -----------
    CB = torch.einsum("bzin,bzjn->bzij", Cc, Bc)                # (B,nc,c,c)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    CBm = torch.where(tri, CB, torch.zeros((), dtype=f32, device=xh.device))
    hb = min(4, H)   # (B,nc,c,c,hb) f32 is the peak intra-chunk tensor
    while H % hb:
        hb -= 1
    y_diag = torch.empty((Bsz, nc, chunk, H, P), dtype=f32, device=xh.device)
    for h0 in range(0, H, hb):
        cum_b = cum[..., h0:h0 + hb]                            # (B,nc,c,hb)
        # mask before exp: cum_i - cum_j > 0 above the diagonal
        diff = cum_b[:, :, :, None, :] - cum_b[:, :, None, :, :]
        decay = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                      torch.full((), -math.inf, dtype=f32,
                                                 device=xh.device)))
        y_diag[..., h0:h0 + hb, :] = torch.einsum(
            "bzij,bzijh,bzjh,bzjhp->bzihp",
            CBm, decay, dtc[..., h0:h0 + hb], xc[..., h0:h0 + hb, :])

    # ---- chunk boundary states ---------------------------------------
    seg = torch.exp(cum[:, :, -1:, :] - cum)                    # decay from j to chunk end
    states = torch.einsum("bzjn,bzjh,bzjhp->bzhpn", Bc, seg * dtc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # (B,nc,H)

    # ---- inter-chunk recurrence (the only sequential part) -----------
    s = (torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
         if init_state is None else init_state.to(f32))
    s_prev = []
    for z in range(nc):
        s_prev.append(s)
        s = chunk_decay[:, z, :, None, None] * s + states[:, z]
    s_prev = torch.stack(s_prev, dim=1)                         # (B,nc,H,P,N)

    # ---- inter-chunk contribution to outputs --------------------------
    y_off = torch.einsum("bzin,bzih,bzhpn->bzihp", Cc, torch.exp(cum), s_prev)
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y.to(xh.dtype), s


def ssd_decode_step(state, x, dt, A, Bv, Cv):
    """One-token SSD update. x: (B,H,P) dt: (B,H) Bv/Cv: (B,N) state: (B,H,P,N)."""
    f32 = torch.float32
    dA = torch.exp(dt.to(f32) * A.to(f32))                      # (B,H)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt.to(f32), Bv.to(f32), x.to(f32))
    state = dA[:, :, None, None] * state + dBx
    y = torch.einsum("bn,bhpn->bhp", Cv.to(f32), state)
    return y.to(x.dtype), state


# xh (B, S, H, P)'s dims -> those of dt (B, S, H), of B/C (B, S, N) and of
# the state (B, H, P, N); decode's x (B, H, P) -> the state
_XH_TO_DT = {0: 0, 2: 2}
_XH_TO_BC = {0: 0}
_XH_TO_STATE = {0: 0, 2: 1}
_X_TO_STATE = {0: 0, 1: 1}


def _local_ssd(xh, dt, A, Bm, Cm, *, chunk: int, init_state=None):
    """``ops.ssd`` (K2 on the card) on this rank's shards of the scan's inputs.

    Plain tensors go straight to ``ops.ssd``. For DTensors: xh (B, S, H,
    P), sharded on its batch and heads at most (``apply_mamba`` constrains
    the projections so), keeps its placements; dt and the initial state
    are placed as its batch and heads, B/C as its batch (whole on the
    heads' mesh dims), and A is sliced to the rank's heads. y and the
    final state come back with those placements. The gradients of B/C
    and A are Partial on each mesh dim where xh is sharded and they are not.
    """
    if not isinstance(xh, DTensor):
        return ops.ssd(xh, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)
    mesh = xh.device_mesh
    pl = xh.placements
    dt = dt.redistribute(mesh, moved_placements(pl, _XH_TO_DT))
    Bm, Cm = (t.redistribute(mesh, moved_placements(pl, _XH_TO_BC)) for t in (Bm, Cm))
    xl, dtl = xh.to_local(), dt.to_local()
    Bl, Cl = (t.to_local(grad_placements=grad_placements(t, xh)) for t in (Bm, Cm))
    h0 = local_offset(xh, 2)
    Al = A.to_local(grad_placements=grad_placements(A, xh))[h0:h0 + xl.shape[2]]
    st_pl = moved_placements(pl, _XH_TO_STATE)
    init = (None if init_state is None
            else init_state.redistribute(mesh, st_pl).to_local())
    y, state = ops.ssd(xl, dtl, Al, Bl, Cl, chunk=chunk, init_state=init)
    return (from_local(y, mesh, pl, xh.shape),
            from_local(state, mesh, st_pl, (xh.shape[0], xh.shape[2], xh.shape[3],
                                            Bm.shape[-1])))


def _local_decode_step(state, x, dt, A, Bv, Cv):
    """``ssd_decode_step`` on this rank's shards (as ``_local_ssd``; x is
    (B, H, P), the state (B, H, P, N) is placed as x's batch and heads)."""
    if not isinstance(x, DTensor):
        return ssd_decode_step(state, x, dt, A, Bv, Cv)
    mesh = x.device_mesh
    pl = x.placements
    st_pl = moved_placements(pl, _X_TO_STATE)
    dtl = dt.redistribute(mesh, pl).to_local()
    Bl, Cl = (t.redistribute(mesh, moved_placements(pl, _XH_TO_BC)).to_local()
              for t in (Bv, Cv))
    xl = x.to_local()
    h0 = local_offset(x, 1)
    y, new = ssd_decode_step(state.redistribute(mesh, st_pl).to_local(), xl, dtl,
                             A.to_local()[h0:h0 + xl.shape[1]], Bl, Cl)
    return (DTensor.from_local(y, mesh, pl, run_check=False),
            DTensor.from_local(new, mesh, st_pl, run_check=False))


def write_layer(dst: torch.Tensor, i: int, src: torch.Tensor) -> None:
    """``dst[i] = src`` in place (a stacked cache leaf's layer i). A DTensor
    ``src`` lands in each rank's shard of ``dst``: it is first placed as
    ``dst``'s layer is (a local slice where only ``dst`` is sharded)."""
    if isinstance(dst, DTensor):                 # cache_specs never shards the layers
        pl = moved_placements(dst.placements, {d: d - 1 for d in range(1, dst.ndim)})
        src = src.redistribute(dst.device_mesh, pl).to_local()
        dst = dst.to_local()
    dst[i].copy_(src)


def pick_chunk(S: int, cfg, rc: RunConfig) -> int:
    """The JAX package's chunk: min(rc.ssd_chunk or cfg.ssm_chunk, S),
    decremented until it divides S."""
    chunk = min(rc.ssd_chunk or cfg.ssm_chunk, S)
    while S % chunk:
        chunk -= 1
    return chunk


def apply_mamba(params, x, cfg, rc: RunConfig, state: Optional[SSMState] = None,
                return_state: bool = False):
    """Mamba2 block body (no residual/norm: transformer.py owns those).

    x: (B, S, D). With ``state`` given and S == 1 this is a decode step.
    Returns (y, new_state | None).
    """
    H, P = cfg.ssm_n_heads, cfg.ssm_head_dim
    cdt = rc.compute_dtype

    # under a mesh, each projection is placed as the scan takes it: batch on
    # dp, heads on tp, B/C whole on tp. B/C's weights are whole on tp: each
    # tp rank takes its cut of their N columns, so no rank repeats another's
    # product, and the output is gathered
    heads, rows, cols = ("dp", None, "tp"), ("dp", None, None), (None, "tp")
    xv = rc.constrain(linear(x, params["in_x"]), heads)
    zv = rc.constrain(linear(x, params["in_z"]), heads)
    Bv = rc.constrain(linear(x, rc.constrain(params["in_B"], cols)), rows)
    Cv = rc.constrain(linear(x, rc.constrain(params["in_C"], cols)), rows)
    dt = rc.constrain(linear(x, params["in_dt"]), heads)

    tails = (None, None, None) if state is None else (state.conv_x, state.conv_B,
                                                      state.conv_C)
    xv, tx = causal_conv(xv, params["conv_x"], tails[0])
    Bv, tb = causal_conv(Bv, params["conv_B"], tails[1])
    Cv, tc = causal_conv(Cv, params["conv_C"], tails[2])
    xv = F.silu(xv)
    Bv = F.silu(Bv)
    Cv = F.silu(Cv)

    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    S = x.shape[1]
    xh = split_heads(xv, H, P)

    new_state = None
    if state is not None and S == 1:
        y, ssd = _local_decode_step(state.ssd, xh[:, 0], dt[:, 0], A, Bv[:, 0], Cv[:, 0])
        y = y[:, None]                                          # (B,1,H,P)
        new_state = SSMState(ssd, tx, tb, tc)
    else:
        init = state.ssd if state is not None else None
        chunk = pick_chunk(S, cfg, rc)
        if xh.device.type in ("cuda", "meta"):   # K2 takes chunks up to MAX_CHUNK
            chunk = ssd_scan.kernel_chunk(S, chunk)
        y, ssd = _local_ssd(xh, dt, A, Bv, Cv, chunk=chunk, init_state=init)
        if return_state:
            new_state = SSMState(ssd, tx, tb, tc)

    # D skip, gate, norm, out-projection
    y = y.float() + params["D_skip"].float()[None, None, :, None] * xh.float()
    y = merge_heads(y).to(cdt)
    y = y * F.silu(zv)
    y = rms_norm(y, params["gate_norm"], cfg.norm_eps)
    return linear(y, params["out"]), new_state


def init_ssm_state(cfg, batch: int, dtype, device, layers: Optional[int] = None) -> SSMState:
    """Zeroed state of one layer, or of ``layers`` stacked layers (leading L axis).

    Every tensor is its own zeroed allocation: the port writes the state
    in place, so no layer may alias another.
    """
    H, P, N = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    W, di = cfg.ssm_conv_width, cfg.ssm_d_inner
    lead = () if layers is None else (layers,)
    return SSMState(
        ssd=torch.zeros(lead + (batch, H, P, N), dtype=torch.float32, device=device),
        conv_x=torch.zeros(lead + (batch, W - 1, di), dtype=dtype, device=device),
        conv_B=torch.zeros(lead + (batch, W - 1, N), dtype=dtype, device=device),
        conv_C=torch.zeros(lead + (batch, W - 1, N), dtype=dtype, device=device),
    )
