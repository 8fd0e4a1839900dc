"""The benchmark's arithmetic: the card's peaks, K1's and K2's bounds, and
the model FLOPs of a forward pass, all from shapes.

The peaks are NVIDIA's data sheet for the H100 SXM (dense rates). The
bounds are copies of ``chip_smoke.py::attention_bound`` and
``ssd_bound``, in seconds; the model FLOPs count 2 a multiply-add of every
product that the forward computes (the projections, the MLP, the head,
attention's q.k and p.v over the pairs the causal mask keeps, the SSD's
products at its chunk), and no elementwise work (norms, the depthwise
conv, the SSD's decays and its carry from chunk to chunk). The benchmark
keeps its own copy so that a change to the program cannot move its
yardstick.
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


def ssd_flops(b, s, h, p, n, chunk, groups: int = 1, causal: bool = True) -> int:
    """2 FLOPs a multiply-add of the chunked SSD (arXiv:2405.21060 section
    6) over (b, s) tokens, h heads of p, state n, chunks of ``chunk``: C.B^T
    over each chunk's (i, j) pairs (once a group: B and C have no head
    axis), and per head the intra-chunk term over the same pairs and p,
    and the carried state's output term and the chunk's own state (chunk
    * n * p each). ``causal=False`` counts every pair of a chunk, as a
    plain reference that masks a dense product computes them."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2 if causal else chunk * chunk
    return 2 * b * nc * (groups * pairs * n + h * (pairs * p + 2 * chunk * n * p))


def ssd_bound(b, s, h, p, n, chunk, x_dtype: str, bc_dtype: str, init_state: bool = False,
              groups: int = 1):
    """(seconds, bound_by): the least time of one K2 call on an H100.

    Bytes: x, dt, A, B, C (and the initial state) read once, y and the
    final state written once. Operations: ``ssd_flops``. The peak is
    bf16's when x, B and C are all bf16, else f32's.
    """
    nbytes = (2 * b * s * h * p * _ITEMSIZE[x_dtype] + b * s * h * 4 + h * 4
              + 2 * b * s * groups * n * _ITEMSIZE[bc_dtype]
              + (2 if init_state else 1) * b * h * p * n * 4)
    flops = ssd_flops(b, s, h, p, n, chunk, groups)
    peak = "bfloat16" if x_dtype == bc_dtype == "bfloat16" else "float32"
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOP_PER_S[peak]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _attn_block_flops(arch: dict, B: int, S: int, causal: bool) -> int:
    d, H, K = arch["d_model"], arch["n_heads"], arch["n_kv_heads"]
    hd = arch["head_dim"] or d // H
    tokens = B * S
    proj = 2 * tokens * d * (2 * H * hd + 2 * K * hd)        # q, k, v, o
    mlp = 2 * tokens * 3 * d * arch["d_ff"]
    return proj + mlp + attention_flops(B, S, S, H, hd, causal)


K2_MAX_CHUNK = 128    # the largest chunk K2 scans at (the program's ``ssd_scan.MAX_CHUNK``)


def ssd_chunk(arch: dict, S: int, run: dict | None = None) -> int:
    """The chunk the program's SSD scans S positions at on the card: the
    run section's ``ssd_chunk`` where it gives one, else the
    configuration's ``ssm_chunk``, cut to K2's largest and to S, then down
    to a divisor of S (the program's ``models/ssm.py::pick_chunk``, then
    ``ssd_scan.kernel_chunk``)."""
    chunk = min((run or {}).get("ssd_chunk") or arch["ssm_chunk"], K2_MAX_CHUNK, S)
    while S % chunk:
        chunk -= 1
    return chunk


def _mamba_layer_flops(arch: dict, B: int, S: int, causal: bool, chunk: int) -> int:
    """The x, z, B, C, dt and out projections and the SSD of one Mamba2 layer."""
    d, P, N = arch["d_model"], arch["ssm_head_dim"], arch["ssm_state"]
    di, G = arch["ssm_expand"] * d, arch.get("ssm_groups", 1)
    H = di // P
    proj = 2 * B * S * d * (3 * di + 2 * G * N + H)
    return proj + ssd_flops(B, S, H, P, N, chunk, G, causal)


def forward_flops(arch: dict, B: int, S: int, *, head_positions: int,
                  run: dict | None = None, causal: bool = True, chunk: int | None = None) -> int:
    """Model FLOPs of one forward over (B, S) tokens of ``arch`` (an
    ``ArchConfig``'s fields), the head applied at ``head_positions``
    positions a row (S in training, 1 in a prefill that emits the last
    logits). ``causal=False`` counts attention's and the SSD's masked pairs
    as computed: what a plain reference that masks a dense product does
    (the CPU test's count). ``chunk``: the SSD's chunk; where None, the
    one the program scans at under ``run``, the configuration's ``train``
    or ``serve`` section (``ssd_chunk``).

    Families: ``dense``; ``ssm``, the Mamba2 stack; ``hybrid`` as the
    program has it, that stack with one shared attention + MLP block after
    every full run of ``attn_every`` layers.
    """
    head = 2 * B * head_positions * arch["d_model"] * _vocab_padded(arch)
    family, L = arch["family"], arch["n_layers"]
    if family == "dense":
        return L * _attn_block_flops(arch, B, S, causal) + head
    if family in ("ssm", "hybrid"):
        mamba = L * _mamba_layer_flops(arch, B, S, causal, chunk or ssd_chunk(arch, S, run))
        shared = 0
        if family == "hybrid":
            shared = (L // arch["attn_every"]) * _attn_block_flops(arch, B, S, causal)
        return mamba + shared + head
    raise ValueError(f"no FLOP count for family {family!r}")


def _vocab_padded(arch: dict) -> int:
    """The vocab rounded up to a multiple of 256: the rows the head holds."""
    return -(-arch["vocab_size"] // 256) * 256
