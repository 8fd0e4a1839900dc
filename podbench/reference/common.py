"""Plain PyTorch pieces of the reference models, in float32.

Nothing here imports the program: the reference works every result out
again from the weights and tokens that the benchmark made. Each product
goes through ``mm``, the precision of the reference: ``exact`` (float32,
TF32 off) or ``fp8`` (the operands rounded to float8 e4m3, and in the
backward the gradient to e5m2, each under a per-tensor scale; the
product summed in float32), the control that the benchmark's limits are
set against.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def _round(x: torch.Tensor, f8) -> torch.Tensor:
    """``x`` rounded to ``f8`` under a per-tensor scale that maps its largest
    magnitude to the format's largest, back in float32."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(f8).max
    return (x / scale).to(f8).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b as an fp8 product: the operands rounded to e4m3; in the
    backward the incoming gradient rounded to e5m2 before both products
    (the usual fp8 training recipe); every sum in float32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round(a, E4M3), _round(b, E4M3)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = (a.shape, b.shape)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, E5M2)
        ga = torch.matmul(qg, qb.transpose(-1, -2)).sum_to_size(ctx.shapes[0])
        gb = torch.matmul(qa.transpose(-1, -2), qg).sum_to_size(ctx.shapes[1])
        return ga, gb


def fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rms_norm(x, scale, eps):
    """RMSNorm with the scale stored as an offset from 1: x / rms(x) * (1 + g)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def rope(x, theta: float):
    """Rotary embedding of x (B, S, heads, hd) at positions 0..S-1, the two
    halves of hd rotated as pairs (not interleaved)."""
    hd, S = x.shape[-1], x.shape[1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, mm, q_block: int):
    """softmax(q k^T / sqrt(hd), causal) v for q (B, S, H, hd) and k, v
    (B, S, K, hd), query head h reading KV head h // (H / K); the queries
    in blocks of ``q_block`` rows, each against every key (masked), so no
    (S, S) score tensor of all heads is held at once."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    kv_of = torch.arange(H, device=q.device) // (H // K)
    kt = k[:, :, kv_of].permute(0, 2, 3, 1)                  # (B, H, hd, S)
    vt = v[:, :, kv_of].permute(0, 2, 1, 3)                  # (B, H, S, hd)
    qt = q.permute(0, 2, 1, 3)                               # (B, H, S, hd)
    scale = 1.0 / math.sqrt(hd)
    keys = torch.arange(S, device=q.device)
    out = []
    for s0 in range(0, S, q_block):
        s1 = min(S, s0 + q_block)
        scores = mm(qt[:, :, s0:s1], kt) * scale
        live = torch.arange(s0, s1, device=q.device)[:, None] >= keys[None, :]
        scores = scores.masked_fill(~live, float("-inf"))
        out.append(mm(torch.softmax(scores, dim=-1), vt))
    return torch.cat(out, dim=2).permute(0, 2, 1, 3)         # (B, S, H, hd)


def attention_block(p, h, arch, mm, q_block: int, on_kv=None):
    """Pre-norm attention + SwiGLU MLP block with residuals. ``p`` holds
    ln1, attn {wq, wk, wv, wo, [bq, bk, bv]}, ln2, mlp {w1, w3, w2}.
    ``on_kv(k, v)`` is handed the rotated k and v (B, S, K, hd)."""
    d, H, K = arch["d_model"], arch["n_heads"], arch["n_kv_heads"]
    hd = arch["head_dim"] or d // H
    B, S, _ = h.shape
    a = p["attn"]
    x = rms_norm(h, p["ln1"], arch["norm_eps"])
    q, k, v = mm(x, a["wq"]), mm(x, a["wk"]), mm(x, a["wv"])
    if "bq" in a:
        q, k, v = q + a["bq"].float(), k + a["bk"].float(), v + a["bv"].float()
    q = rope(q.reshape(B, S, H, hd), arch["rope_theta"])
    k = rope(k.reshape(B, S, K, hd), arch["rope_theta"])
    v = v.reshape(B, S, K, hd)
    if on_kv is not None:
        on_kv(k, v)
    o = causal_attention(q, k, v, mm, q_block).reshape(B, S, H * hd)
    h = h + mm(o, a["wo"])
    x = rms_norm(h, p["ln2"], arch["norm_eps"])
    m = p["mlp"]
    return h + mm(F.silu(mm(x, m["w1"])) * mm(x, m["w3"]), m["w2"])


def logits(params, h, arch, mm):
    """The final norm and the head (the embedding's rows where tied)."""
    head = params["embed"] if arch["tie_embeddings"] else params["head"]
    return mm(rms_norm(h, params["final_norm"], arch["norm_eps"]), head.t())


def cross_entropy(lg, labels, vocab_size: int):
    """Mean next-token CE in float32; the padded vocab slots take no mass."""
    lg = lg.float()
    if lg.shape[-1] > vocab_size:
        lg = lg.masked_fill(torch.arange(lg.shape[-1], device=lg.device) >= vocab_size,
                            float("-inf"))
    return (torch.logsumexp(lg, -1) - lg.gather(-1, labels.long()[..., None])[..., 0]).mean()


def layers(tree, n: int):
    """The ``n`` layers of a stacked tree: each leaf unbound once, so a
    gradient flows back into one stacked buffer a leaf."""
    cols = {k: layers(v, n) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    return [{k: v[i] for k, v in cols.items()} for i in range(n)]
