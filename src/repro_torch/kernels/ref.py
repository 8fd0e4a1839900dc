"""Plain PyTorch versions of the kernels.

The CPU tests hold these against the JAX package's ``kernels/ref.py``;
``chip_smoke.py`` holds each CUDA kernel against them on the card. They
are intentionally the simplest formulations (O(S^2) attention, the
step-by-step SSD recurrence).
"""
from __future__ import annotations

import math

import torch


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,T,K,hd) -> (B,T,H,hd) by broadcasting each KV head over its group.

    Query head h reads KV head h // G. The result is a contiguous copy.
    """
    B, T, K, hd = k.shape
    G = n_heads // K
    k = k[:, :, :, None, :].expand(B, T, K, G, hd)
    return k.reshape(B, T, K * G, hd)


def causal_mask(S: int, T: int, q_offset: int, device) -> torch.Tensor:
    """(S, T) bool: query row i (global row ``q_offset + i``) sees keys j <= q_offset + i."""
    return ((torch.arange(S, device=device)[:, None] + q_offset)
            >= torch.arange(T, device=device)[None, :])


def check_q_offset(S: int, T: int, q_offset: int, causal: bool) -> None:
    """Refuse a negative offset, and a causal block of rows at an offset
    that reaches past the last key. ``q_offset=0`` is the call without an
    offset, which takes any S and T (rows past T see every key)."""
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, not {q_offset}")
    if causal and q_offset and q_offset + S > T:
        raise ValueError(f"causal attention with q_offset={q_offset} and S={S} needs "
                         f"T >= {q_offset + S} keys, not {T}")


def attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Dense reference attention (plain K1). q: (B, S, H, hd), k/v: (B, T, K, hd).

    K divides H; query head h reads KV head h // (H // K) (``repeat_kv``),
    so K == H is the full-H form. Query row i is global row ``q_offset +
    i`` of the causal mask (a rank's block of rows under q-sequence
    tensor parallelism); without ``causal`` the offset has no effect.
    Computed in f32 throughout; the output takes v's dtype.
    """
    H, K = q.shape[2], k.shape[2]
    if H % K:
        raise ValueError(f"attention takes a number of KV heads that divides H; "
                         f"H={H}, K={K}")
    check_q_offset(q.shape[1], k.shape[1], q_offset, causal)
    if K != H:
        k, v = repeat_kv(k, H), repeat_kv(v, H)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        mask = causal_mask(s.shape[-2], s.shape[-1], q_offset, s.device)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(v.dtype)


def attention_bwd(q, k, v, out, dout, *, causal: bool = True, q_offset: int = 0):
    """Gradients of ``attention_ref`` -> (dq, dk, dv) in q's, k's and v's dtypes.

    The backward of K1 under ``kernels.flash_attention.FlashAttentionFn``:
    the counterpart of what XLA's autodiff computes for the JAX model's
    attention, written out in tensor ops (the Pallas kernel has no
    backward). ``out`` is the forward's output and ``dout`` its gradient,
    both (B, S, H, hd); k/v are (B, T, K, hd), H % K == 0; ``q_offset``
    as in ``attention_ref``. In f32, with P recomputed from q and k under
    the reference's -1e30 causal mask:

      dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dO * O)),
      dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd),

    and dK, dV summed over the H / K query heads that read each KV head.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"attention takes a number of KV heads that divides H; "
                         f"H={H}, K={K}")
    check_q_offset(S, T, q_offset, causal)
    scale = 1.0 / math.sqrt(hd)
    qf, dof = q.float(), dout.float()
    kf, vf = repeat_kv(k, H).float(), repeat_kv(v, H).float()
    s = torch.einsum("bshd,bthd->bhst", qf, kf) * scale
    if causal:
        s = torch.where(causal_mask(S, T, q_offset, s.device), s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    del s
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    dp = torch.einsum("bshd,bthd->bhst", dof, vf)
    delta = (dof * out.float()).sum(-1).transpose(1, 2)[..., None]     # (B, H, S, 1)
    ds = p * (dp - delta)
    del p, dp
    dq = torch.einsum("bhst,bthd->bshd", ds, kf) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, qf) * scale
    G = H // K
    dk = dk.reshape(B, T, K, G, hd).sum(3)
    dv = dv.reshape(B, T, K, G, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_ref(x, dt, A, B, C, init_state=None):
    """Sequential SSD recurrence (plain K2; the literal state-space definition).

    x: (b, s, h, p)  dt: (b, s, h)  A: (h,)  B, C: (b, s, n)
    Returns (y: (b, s, h, p) in x's dtype, final_state: (b, h, p, n) f32).

      state_t = exp(dt_t * A) * state_{t-1} + dt_t * B_t (x) x_t
      y_t     = C_t . state_t

    The state starts at ``init_state`` (f32, (b, h, p, n)), or at zero
    when it is None, as in the JAX package's oracle.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    A = A.float()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()                                      # (b, h)
        dA = torch.exp(dtt * A)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dtt, B[:, t].float(), x[:, t].float())
        state = dA[:, :, None, None] * state + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t].float(), state))
    return torch.stack(ys, dim=1).to(x.dtype), state
