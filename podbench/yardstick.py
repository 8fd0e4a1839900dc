"""The benchmark's arithmetic: the card's peaks, K1's bound, and the model
FLOPs of a forward pass, all from shapes.

The peaks are NVIDIA's data sheet for the H100 SXM (dense rates). The
bound is a copy of ``chip_smoke.py::attention_bound``; the model FLOPs
count 2 a multiply-add of every product that the forward computes (the
projections, the MLP, the head, attention's q.k and p.v over the pairs the
causal mask keeps), and no elementwise work. The benchmark keeps its own copy so
that a change to the program cannot move its yardstick.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"bfloat16": 989e12, "float32": 67e12}

_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def attn_pairs(S: int, T: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs that attention computes: those the causal mask
    keeps (row i, global row q_offset + i, keeps q_offset + i + 1 keys),
    or all S * T when not causal."""
    if not causal:
        return S * T
    return sum(min(q_offset + i + 1, T) for i in range(S))


def attention_flops(B, S, T, H, hd, causal: bool, q_offset: int = 0) -> int:
    """2 FLOPs a multiply-add of q.k and of p.v, over the pairs, every query head."""
    return 4 * B * H * hd * attn_pairs(S, T, causal, q_offset)


def attention_bound(B, S, T, H, K, hd, dtype: str, causal: bool, q_offset: int = 0):
    """(seconds, bound_by): the least time of one K1 call on an H100.

    Bytes: q (H heads), k and v (K heads) read once, o written once.
    Operations: ``attention_flops``.
    """
    nbytes = (2 * B * S * H * hd + 2 * B * T * K * hd) * _ITEMSIZE[dtype]
    flops = attention_flops(B, S, T, H, hd, causal, q_offset)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOP_PER_S[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _attn_block_flops(arch: dict, B: int, S: int, causal: bool) -> int:
    d, H, K = arch["d_model"], arch["n_heads"], arch["n_kv_heads"]
    hd = arch["head_dim"] or d // H
    tokens = B * S
    proj = 2 * tokens * d * (2 * H * hd + 2 * K * hd)        # q, k, v, o
    mlp = 2 * tokens * 3 * d * arch["d_ff"]
    return proj + mlp + attention_flops(B, S, S, H, hd, causal)


def forward_flops(arch: dict, B: int, S: int, *, head_positions: int,
                  causal: bool = True) -> int:
    """Model FLOPs of one forward over (B, S) tokens of ``arch`` (an
    ``ArchConfig``'s fields), the head applied at ``head_positions``
    positions a row (S in training, 1 in a prefill that emits the last
    logits). ``causal=False`` counts attention's masked pairs as computed:
    what a plain reference that masks a dense product does (the CPU test's
    count).
    """
    head = 2 * B * head_positions * arch["d_model"] * _vocab_padded(arch)
    family = arch["family"]
    if family == "dense":
        return arch["n_layers"] * _attn_block_flops(arch, B, S, causal) + head
    raise ValueError(f"no FLOP count for family {family!r}")


def _vocab_padded(arch: dict) -> int:
    """The vocab rounded up to a multiple of 256: the rows the head holds."""
    return -(-arch["vocab_size"] // 256) * 256
