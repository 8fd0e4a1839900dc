"""Shared neural-net layers (plain functions over tensors and param dicts)."""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.parallel.mesh import (from_local, grad_placements, local_offset,
                                       reduce_partial, replicate_like, shard_count,
                                       unshard_dim)


def _no_constrain(x, logical_axes):
    return x


def _no_gather(w):
    return w


# ---------------------------------------------------------------------------
# Run-time configuration threaded through model code.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RunConfig:
    """How to *run* a model (orthogonal to ArchConfig = what the model is).

    ``remat`` and ``remat_policy`` are the JAX package's: activation
    checkpointing of each layer's block under a gradient
    (``transformer._maybe_remat``); ``"dots"`` saves the matmul outputs
    and recomputes the rest, any other policy recomputes the whole block.
    ``moe_group`` is the JAX package's too: the MoE layer routes its
    tokens in groups of ``min(moe_group, tokens)``, each with its own
    expert capacity (``moe.apply_moe``).
    The sharding hooks are the JAX package's too, injected by the
    runtime when it is given a mesh (``parallel.mesh``): ``constrain(x,
    logical_axes)`` redistributes an activation (the identity without a
    mesh), ``attn_shard`` picks head ("heads") or query-row ("seq")
    tensor parallelism in the attention, ``attn_exit_constrain`` also
    constrains the residual stream after the attention, and
    ``seq_shard_carry`` keeps the residual stream sequence-sharded on
    the tp axis between blocks (Megatron-SP). ``fsdp_gather(w)`` gathers
    a layer's weight over its FSDP mesh dims where the layer runs
    (``transformer._use``; the identity without a mesh), as XLA gathers
    inside the JAX package's layer scan. The defaults leave every
    path without a mesh as it was. The JAX RunConfig's attention-dispatch
    knobs have no counterpart: the port's full-H attention always goes
    through ``kernels.ops.attention`` and its chunked SSD scan through
    ``kernels.ops.ssd``.
    """

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    device: str = "cuda"
    remat: bool = False                # activation checkpointing over blocks
    remat_policy: str = "none"        # none | dots | everything
    moe_group: int = 2048              # MoE dispatch group size (tokens)
    ssd_chunk: int = 0                 # SSD chunk override (0 = ArchConfig's)
    attn_shard: str = "heads"          # 'heads' | 'seq' (q-sequence TP when
                                       #  n_heads doesn't divide the TP axis)
    attn_exit_constrain: bool = False  # constrain h after the attention residual too
    seq_shard_carry: bool = False      # Megatron-SP: residual stream (B,S,D) on 'tp'
    constrain: Callable = _no_constrain   # constrain(x, logical_axes) -> x
    fsdp_gather: Callable = _no_gather    # fsdp_gather(w) -> w whole on its FSDP dims

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA request when there is no card.

    The port never carries on silently on the CPU: the caller asks for
    it with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Initializers (same distributions as the JAX package; jax.random's bits
# cannot be reproduced, so parity tests share weights via convert.py)
# ---------------------------------------------------------------------------
def dense_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype,
               device, scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in initializer (what most LMs ship with).

    ``gen=None`` is allowed only on the meta device (shape-only init).
    """
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype,
               device) -> torch.Tensor:
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    w.normal_(0.0, 0.02, generator=gen)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """RMSNorm in f32, cast back to input dtype; scale is (1 + g).

    A ``Partial`` ``x`` (the residual stream after a row-parallel product,
    unconstrained) is summed first: DTensor would sum it into rows sharded
    over that mesh dim, which its backward cannot flatten where they do
    not divide (8 rows on 7 ranks)."""
    x = reduce_partial(x)
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
    """x @ w with w stored (in, out), as in the JAX package.

    A DTensor ``x`` sharded on a leading dim past the first (the sequence,
    under q-sequence TP or Megatron-SP) has that dim gathered first: DTensor
    flattens the leading dims for the product, and torch 2.11 refuses to
    flatten a sharded dim that is not the first. A ``Partial`` ``x`` (the
    residual stream after a row-parallel product) is summed first: DTensor
    would sum the product later, at the next nonlinear op, into rows
    sharded over that mesh dim, and fails on its own view of them where
    they do not divide (8 rows on 7 ranks).
    """
    for d in range(1, x.dim() - 1):
        x = unshard_dim(x, d)
    x = reduce_partial(x)
    y = matmul(x, w)
    if b is not None:
        y = y + b
    return y


def uneven_rows(x) -> bool:
    """Whether the DTensor ``x``'s rows (dim 0) are cut unevenly over its
    ranks: a micro-batch of fewer rows than its dp ranks
    (``runtime.train.micro_batch``), some ranks holding one row, some none;
    or one row sharded (over mesh dims of size 1), which DTensor cannot
    flatten either."""
    n = shard_count(x, 0)
    return n > 1 and x.shape[0] % n != 0 or (isinstance(x, DTensor) and x.shape[0] == 1
                                             and Shard(0) in x.placements)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for an activation ``x`` (..., D) and a weight ``w`` (D, F).

    Where ``x``'s rows are cut unevenly (``uneven_rows``) DTensor cannot
    run the product, which flattens the leading dims, so each rank
    multiplies its own shards, placed on each mesh dim as DTensor places
    an even product: where ``x``'s rows are sharded, ``w`` is gathered
    (its FSDP dim); where ``x``'s D is sharded, or ``x`` is whole and
    ``w``'s D is sharded, each rank takes its slice of D and the product
    is summed at once (an all-reduce: DTensor gathers rows cut unevenly
    where a later op meets a Partial operand); where only ``w``'s F is
    sharded, so is the product's (a ``w`` already gathered is not gathered
    again). Every other product is DTensor's (or plain), ``x``'s D first
    cut where only ``w``'s is sharded (``_cut_contraction``), as above.
    """
    if not uneven_rows(x):
        return _cut_contraction(x, w) @ w
    mesh, last = x.device_mesh, x.ndim - 1
    if any(isinstance(p, Shard) and 0 < p.dim < last for p in x.placements):
        raise ValueError(f"rows cut unevenly and an inner dim sharded: {x.placements}")
    rule = []                       # (x's, w's, the product's) placement a mesh dim
    for px, pw in zip(x.placements, w.placements):
        if px == Shard(0):
            rule.append((px, Replicate(), px))
        elif px == Shard(last) or pw == Shard(0):
            rule.append((Shard(last), Shard(0), Partial()))
        else:
            rule.append((px, pw, Shard(last) if pw == Shard(1) else px))
    x_pl, w_pl, out_pl = zip(*rule)
    x, w = x.redistribute(mesh, x_pl), w.redistribute(mesh, w_pl)
    y = (x.to_local(grad_placements=grad_placements(x, w))
         @ w.to_local(grad_placements=grad_placements(w, x)))
    return reduce_partial(from_local(y, mesh, out_pl, x.shape[:-1] + w.shape[1:]))


def _cut_contraction(x, w):
    """A DTensor ``x`` with its last dim cut over each mesh dim where ``w``'s
    first (the contraction) is sharded and ``x``'s is whole: the product
    is then Partial there, and its backward takes w's gradient in w's own
    shard. Left to itself, DTensor multiplies such an ``x`` against w
    gathered, or computes w's whole gradient on every rank of that dim
    (a q-sequence-parallel block's ``wo``, whose input's heads were
    gathered). Its backward gathers x's gradient."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x
    last = x.ndim - 1
    placements = [Shard(last) if pw == Shard(0) and px == Replicate() else px
                  for px, pw in zip(x.placements, w.placements)]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def swiglu(x, w1, w3, w2):
    """SwiGLU MLP: w2( silu(x w1) * (x w3) )."""
    return linear(F.silu(linear(x, w1)) * linear(x, w3), w2)


def geglu(x, w1, w3, w2):
    """GeGLU MLP (gemma): w2( gelu(x w1) * (x w3) ), tanh-approximated gelu."""
    return linear(F.gelu(linear(x, w1), approximate="tanh") * linear(x, w3), w2)


def init_mlp(gen, d_model: int, d_ff: int, dtype, device):
    return {
        "w1": dense_init(gen, (d_model, d_ff), dtype, device),
        "w3": dense_init(gen, (d_model, d_ff), dtype, device),
        "w2": dense_init(gen, (d_ff, d_model), dtype, device),
    }


def apply_mlp(params, x, gelu: bool = False):
    fn = geglu if gelu else swiglu
    return fn(x, params["w1"], params["w3"], params["w2"])


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)          # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S).

    Split-halves convention (not interleaved), computed in f32.
    """
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)        # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., S, hd/2)
    if angles.ndim == x.ndim - 1 and angles.shape[0] == 1:
        # one row of positions for every row of x: broadcast from the left, so
        # that a DTensor x of one row cut over several ranks is not gathered
        angles = angles[0]
    cos = replicate_like(torch.cos(angles)[..., None, :], x)    # (..., S, 1, hd/2)
    sin = replicate_like(torch.sin(angles)[..., None, :], x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab_size: int) -> torch.Tensor:
    """CE in f32 with padded-vocab masking. logits: (..., Vp), labels ints.

    The padded slots (index >= ``vocab_size``) are set to -1e9 before the
    log-sum-exp, as in the JAX package, so they take no probability and
    receive no gradient. A DTensor whose vocab is sharded is reduced on
    each rank's columns (``_VocabShardedCE``): no rank gathers the vocab;
    so are ``VocabPieces`` (``spread_logits``).
    """
    if isinstance(logits, VocabPieces):
        return _pieces_cross_entropy(logits, labels, vocab_size)
    if _vocab_mesh_dims(logits):
        return _sharded_cross_entropy(logits, labels, vocab_size)
    vp = logits.shape[-1]
    logits = logits.float()
    if vp > vocab_size:
        pad_mask = torch.arange(vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(replicate_like(pad_mask, logits), -1e9)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def _vocab_mesh_dims(logits) -> list:
    """The mesh dims that shard the last dim of a DTensor ``logits``."""
    if not isinstance(logits, DTensor):
        return []
    last = logits.ndim - 1
    return [i for i, p in enumerate(logits.placements) if isinstance(p, Shard) and p.dim == last]


def _wait(x):
    return x.wait() if isinstance(x, funcol.AsyncCollectiveTensor) else x


def _all_reduce(x: torch.Tensor, op: str, groups) -> torch.Tensor:
    for group in groups:
        x = _wait(funcol.all_reduce(x, op, group))
    return x


def _masked_local(x: torch.Tensor, v0: int, vocab_size: int) -> torch.Tensor:
    """A new f32 copy of this rank's columns [v0, v0 + width) of the
    logits, its padded ones (global index >= ``vocab_size``) set to -1e9;
    the callers work on it in place, so one f32 copy is alive at a time."""
    xf = x.to(torch.float32, copy=True)
    if v0 + x.shape[-1] > vocab_size:
        cols = torch.arange(v0, v0 + x.shape[-1], device=x.device)
        xf.masked_fill_(cols >= vocab_size, -1e9)
    return xf


class _VocabShardedCE(torch.autograd.Function):
    """The CE of each row on this rank's columns [v0, v0 + width) of the
    logits, the row's max, gold logit and sum of exponentials all-reduced
    over ``groups`` (the process groups of the mesh dims that shard the
    vocab): three all-reduces of one f32 a row. The backward needs no
    collective: each rank's columns get ``(softmax - onehot) * g``, the
    padded ones exactly 0 (exp(-1e9 - lse) underflows to 0). It saves the
    logits as they came (bf16 under the compute dtype) and the row's
    log-sum-exp."""

    @staticmethod
    def forward(ctx, x, labels, v0: int, vocab_size: int, groups):
        xf = _masked_local(x, v0, vocab_size)
        rows, width = xf.shape[:-1], xf.shape[-1]
        idx = labels.long() - v0
        gold = torch.zeros(rows, device=xf.device)
        if width:
            m = xf.amax(dim=-1)
            gold = torch.where((idx >= 0) & (idx < width), torch.gather(
                xf, -1, idx.clamp(0, width - 1)[..., None])[..., 0], gold)
        else:                                    # an empty shard of an uneven cut
            m = torch.full(rows, float("-inf"), device=xf.device)
        m = _all_reduce(m, "max", groups)
        gold = _all_reduce(gold, "sum", groups)
        s = _all_reduce(xf.sub_(m[..., None]).exp_().sum(dim=-1), "sum", groups)
        lse = torch.log(s) + m
        ctx.save_for_backward(x, idx, lse)
        ctx.v0, ctx.vocab_size = v0, vocab_size
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        x, idx, lse = ctx.saved_tensors
        grad = _masked_local(x, ctx.v0, ctx.vocab_size).sub_(lse[..., None]).exp_()
        width = grad.shape[-1]
        if width:
            here = ((idx >= 0) & (idx < width)).to(grad.dtype)
            grad.scatter_add_(-1, idx.clamp(0, width - 1)[..., None], -here[..., None])
        return grad.mul_(g[..., None]).to(x.dtype), None, None, None, None


def _sharded_cross_entropy(logits: DTensor, labels, vocab_size: int) -> DTensor:
    """``softmax_cross_entropy`` of logits whose vocab is sharded: the
    per-row loss as a DTensor in the rows' placements (the logits' own,
    with the vocab's mesh dims replicated); the logits' gradient comes
    back in their own placements, vocab-sharded."""
    logits = reduce_partial(logits)
    mesh, dims = logits.device_mesh, _vocab_mesh_dims(logits)
    rows_pl = [Replicate() if i in dims else p for i, p in enumerate(logits.placements)]
    if not isinstance(labels, DTensor):
        labels = replicate_like(labels, logits)
    labels = labels.redistribute(mesh, rows_pl).to_local()
    loss = _VocabShardedCE.apply(logits.to_local(), labels, local_offset(logits, -1),
                                 vocab_size, [mesh.get_group(i) for i in dims])
    return from_local(loss, mesh, rows_pl, logits.shape[:-1])


# ---------------------------------------------------------------------------
# The head on rows cut unevenly: each rank's piece of the vocab, model-major
# ---------------------------------------------------------------------------
class VocabPieces(NamedTuple):
    """Logits whose vocab is cut into one piece a rank, the pieces of each of
    the head's own vocab slices cut again over other mesh dims
    (``spread_logits``): an order no DTensor placement has, so they travel
    as each rank's ``local`` columns ``[v0, v0 + width)`` of every row, the
    whole logits' ``shape`` and the ``plan`` of the cut.
    ``softmax_cross_entropy`` takes them; ``to_dtensor`` gathers them for a
    caller that reads the logits."""
    local: torch.Tensor
    v0: int
    shape: Tuple[int, ...]
    plan: Any

    def to_dtensor(self) -> DTensor:
        """The logits with the vocab on the head's own mesh dims: each rank's
        slice whole (the pieces gathered over the dims that cut it again)."""
        mesh, last = self.plan.mesh, len(self.shape) - 1
        return from_local(_GatherPieces.apply(self.local, self.plan), mesh,
                          [Shard(last) if i in self.plan.vocab else Replicate()
                           for i in range(mesh.ndim)], self.shape)


def _chunk(size: int, n: int, i: int) -> Tuple[int, int]:
    """(start, length) of chunk ``i`` of ``n`` of ``size`` cut as ``torch.chunk``
    (and DTensor's ``Shard``) cuts it: chunks of ``ceil(size / n)``, the last
    ones shorter or empty."""
    c = -(-size // n)
    start = min(i * c, size)
    return start, min(c, size - start)


class _Plan(NamedTuple):
    """How this rank's piece of the head is cut (``spread_logits``)."""
    mesh: Any
    vocab: List[int]        # the mesh dims that cut the head's vocab
    cut: List[int]          # the mesh dims that cut each vocab slice again, in mesh order
    d_dims: List[int]       # the mesh dims that cut the head's D, in mesh order
    d: int                  # the head's whole D
    n: int                  # the rows of this rank's vocab slice
    c: int                  # the rows of a piece, padded: ceil(n / pieces)
    k: int                  # this rank's piece
    width: int              # its rows, unpadded

    def coord(self, i: int) -> int:
        return self.mesh.get_local_rank(i)

    def groups(self) -> list:
        """The process groups of the mesh dims that cut the vocab into pieces."""
        return [self.mesh.get_group(i) for i in self.vocab + self.cut]

    def d_sizes(self, i: int) -> List[int]:
        """The D columns each rank of mesh dim ``i`` holds once the D dims
        after ``i`` are gathered: chunks of the span the dims before it cut."""
        size = self.d
        for e in self.d_dims[:self.d_dims.index(i)]:
            size = _chunk(size, self.mesh.size(e), self.coord(e))[1]
        return [_chunk(size, self.mesh.size(i), j)[1] for j in range(self.mesh.size(i))]

    def stages(self) -> List[Tuple[str, int]]:
        """In forward order: take this rank's pieces along each cut dim that
        replicates the head, then undo the D cut from its last mesh dim to
        its first: an all-to-all where the dim also cuts the pieces, else
        an all-gather."""
        return ([("take", i) for i in self.cut if i not in self.d_dims]
                + [("a2a" if i in self.cut else "gather", i) for i in reversed(self.d_dims)])


def _a2a(x, ax: int, group, cols: List[int]):
    """All-to-all over ``group``: ``x``'s index ``j`` along axis ``ax`` goes
    to rank ``j``, and what rank ``j`` sends back, ``cols[j]`` columns of the
    last dim, joins along it (``ax`` left of size 1)."""
    send = x.movedim(ax, 0)
    rest = tuple(send.shape[1:-1])
    per = math.prod(rest)
    out = _wait(funcol.all_to_all_single(send.reshape(-1), [per * w for w in cols],
                                         [per * x.shape[-1]] * len(cols), group))
    parts = out.split([per * w for w in cols])
    return torch.cat([t.reshape(rest + (w,)) for t, w in zip(parts, cols)], -1).unsqueeze(ax)


def _a2a_back(g, ax: int, group, cols: List[int], mine: int):
    """The inverse of ``_a2a``: the last dim's ``cols[j]`` columns go back to
    rank ``j``, and what each sends (``mine`` columns) stacks along ``ax``."""
    g = g.squeeze(ax)
    rest = g.shape[:-1]
    per = math.prod(rest)
    flat = torch.cat([t.reshape(-1) for t in g.split(cols, -1)])
    out = _wait(funcol.all_to_all_single(flat, [per * mine] * len(cols),
                                         [per * w for w in cols], group))
    return out.reshape((len(cols),) + tuple(rest) + (mine,)).movedim(0, ax)


def _gather_cols(x, group, cols: List[int]):
    """The last dim gathered over ``group``, rank ``j`` holding ``cols[j]``
    (padded to the widest for the all-gather)."""
    pad = max(cols) - x.shape[-1]
    x = F.pad(x, (0, pad)) if pad else x
    out = _wait(funcol.all_gather_tensor(x.unsqueeze(0).contiguous(), 0, group))
    return torch.cat([out[j, ..., :w] for j, w in enumerate(cols)], -1)


def _gather_axis(x, ax: int, group):
    """Axis ``ax`` (of size 1 here) gathered over ``group``."""
    return _wait(funcol.all_gather_tensor(x.contiguous(), ax, group))


class _HeadPiece(torch.autograd.Function):
    """This rank's piece of the head, D whole, from its block (its vocab
    slice's rows, its D chunk): the slice padded to ``pieces x c`` rows and
    laid out (one axis a cut dim, ..., c, D) as the pieces are numbered,
    then ``_Plan.stages``. No rank holds or moves more than its slice. The
    backward runs the stages the other way: the piece's gradient goes to
    the ranks that hold its D (an all-to-all), is gathered over the dims
    that replicate the head, and comes back in the block's own placements."""

    @staticmethod
    def forward(ctx, w, plan: _Plan):
        ctx.plan = plan
        sizes = [plan.mesh.size(i) for i in plan.cut]
        x = F.pad(w, (0, 0, 0, math.prod(sizes) * plan.c - plan.n))
        x = x.reshape(tuple(sizes) + (plan.c, w.shape[1]))
        for kind, i in plan.stages():
            group = (plan.mesh, i)
            if kind == "take":
                x = x.narrow(plan.cut.index(i), plan.coord(i), 1)
            elif kind == "a2a":
                x = _a2a(x, plan.cut.index(i), group, plan.d_sizes(i))
            else:
                x = _gather_cols(x, group, plan.d_sizes(i))
        return x.reshape(plan.c, plan.d)[:plan.width].contiguous()

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        g = F.pad(g, (0, 0, 0, plan.c - plan.width))
        g = g.reshape((1,) * len(plan.cut) + (plan.c, plan.d))
        for kind, i in reversed(plan.stages()):
            group = (plan.mesh, i)
            if kind == "take":
                g = _gather_axis(g, plan.cut.index(i), group)
            else:
                cols = plan.d_sizes(i)
                j = plan.coord(i)
                if kind == "a2a":
                    g = _a2a_back(g, plan.cut.index(i), group, cols, cols[j])
                else:
                    g = g.narrow(-1, sum(cols[:j]), cols[j])
        return g.reshape(-1, g.shape[-1])[:plan.n], None


class _GatherPieces(torch.autograd.Function):
    """Each rank's logits piece (..., width) gathered over the cut dims, the
    innermost first, into its vocab slice (..., n); the backward takes the
    piece back."""

    @staticmethod
    def forward(ctx, x, plan: _Plan):
        ctx.plan = plan
        x = F.pad(x, (0, plan.c - x.shape[-1]))
        for i in reversed(plan.cut):
            x = _gather_axis(x.unsqueeze(0), 0, (plan.mesh, i))
            x = x.movedim(0, -2).reshape(x.shape[1:-1] + (-1,))
        return x[..., :plan.n].contiguous()

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        start = min(plan.k * plan.c, plan.n)
        return g[..., start:start + plan.width].contiguous(), None


def spread_logits(h: DTensor, head: DTensor) -> VocabPieces:
    """``h @ head.T`` where ``h``'s rows are cut unevenly over its dp mesh
    dims (``uneven_rows``): every rank takes all the rows against its own
    piece of the vocab, so the product and the loss are shared by all the
    ranks, not left to those that hold a row.

    The vocab is cut model-major: the head's rows stay cut as the head cuts
    them (its vocab mesh dims), and each slice is cut again over the rows'
    dp mesh dims that do not cut the vocab, so rank (p, d, m) of a (pod,
    data, model) mesh takes piece ``p·D + d`` of its ``model`` slice, which
    lies inside the slice it holds. ``_HeadPiece`` brings that piece's D
    together from the ranks that hold it; the head's whole never moves
    (DTensor cuts a dim over several mesh dims pod-major, and so gathered
    the whole head to reach its pieces). The gradient of ``h``'s rows is
    Partial over the pieces' mesh dims; the head's comes back in its own
    placements."""
    mesh = h.device_mesh
    rows = [i for i, p in enumerate(h.placements) if p == Shard(0)]
    vocab = [i for i, p in enumerate(head.placements) if p == Shard(0)]
    d_dims = [i for i, p in enumerate(head.placements) if p == Shard(1)]
    if any(isinstance(p, Partial) for p in head.placements):
        raise ValueError(f"a head with a Partial placement: {head.placements}")
    cut = [i for i in rows if i not in vocab]
    w = head.to_local()
    n, pieces = w.shape[0], math.prod(mesh.size(i) for i in cut)
    k = 0
    for i in cut:
        k = k * mesh.size(i) + mesh.get_local_rank(i)
    c = -(-n // pieces)
    start, width = _chunk(n, pieces, k)
    plan = _Plan(mesh, vocab, cut, d_dims, head.shape[1], n, c, k, width)
    piece = _HeadPiece.apply(w, plan)
    x = h.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if i in vocab + cut else Replicate()
                         for i in range(mesh.ndim)])
    return VocabPieces(x @ piece.T, local_offset(head, 0) + start,
                       tuple(h.shape[:-1]) + (head.shape[0],), plan)


def _pieces_cross_entropy(logits: VocabPieces, labels, vocab_size: int) -> DTensor:
    """``softmax_cross_entropy`` of ``VocabPieces``: every rank holds every
    row, so the per-row loss is whole on each (a replicated DTensor)."""
    mesh = logits.plan.mesh
    if isinstance(labels, DTensor):
        labels = labels.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    loss = _VocabShardedCE.apply(logits.local, labels, logits.v0, vocab_size,
                                 logits.plan.groups())
    return from_local(loss, mesh, [Replicate()] * mesh.ndim, logits.shape[:-1])


# ---------------------------------------------------------------------------
# Embedding lookup on a vocab-sharded table
# ---------------------------------------------------------------------------
class _VocabShardedLookup(torch.autograd.Function):
    """``table[tokens]`` on this rank's vocab rows [v0, v0 + n) of the table
    (``table`` is that slice): a token outside them reads a zero row, and
    the rows are summed over ``groups`` (the process groups of the mesh
    dims that cut the vocab), where exactly one rank holds each token's
    row, so the sum is that row. The backward needs no collective: each
    rank adds the gradient's rows of its own tokens into its slice
    (``index_put_`` with accumulate, as the plain index's backward does);
    the others, clamped into the slice, add zero rows."""

    @staticmethod
    def forward(ctx, table, tokens, v0: int, groups):
        n = table.shape[0]
        idx = tokens.long() - v0
        here = (idx >= 0) & (idx < n)
        idx = idx.clamp(0, max(n - 1, 0))
        if n:
            rows = table[idx].masked_fill(~here[..., None], 0)
        else:                                    # an empty shard of an uneven cut
            rows = table.new_zeros(tuple(idx.shape) + (table.shape[1],))
        ctx.save_for_backward(idx, here)
        ctx.table_shape = table.shape
        return _all_reduce(rows, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        idx, here = ctx.saved_tensors
        grad = g.new_zeros(ctx.table_shape)
        if grad.shape[0]:          # another rank's token adds a zero row to a clamped slot
            grad.index_put_((idx,), g.masked_fill(~here[..., None], 0), accumulate=True)
        return grad, None, None, None


def vocab_sharded_lookup(table: DTensor, tokens) -> DTensor:
    """``table[tokens]`` for a DTensor table (Vp, D) whose vocab may be cut
    over some mesh dims, as Megatron's vocab-parallel embedding does it.

    The table's D is gathered (its FSDP mesh dims), so each rank holds its
    vocab rows whole: a slice of the table, never the whole. The tokens
    are made whole on the vocab's mesh dims, and each rank reads its own
    tokens' rows by a masked gather, summed over the vocab's mesh dims
    (``_VocabShardedLookup``). The rows come back in the tokens'
    placements; the slice's gradient is Partial where the tokens are
    sharded, and the gather's backward reduces it into the table's own
    placements (a reduce-scatter of the slice over the FSDP dims).
    """
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    tokens = replicate_like(tokens, table) if not isinstance(tokens, DTensor) else tokens
    tokens = tokens.redistribute(mesh, [Replicate() if i in vocab else p
                                        for i, p in enumerate(tokens.placements)])
    part = table.redistribute(mesh, [Shard(0) if i in vocab else Replicate()
                                     for i in range(mesh.ndim)])
    rows = _VocabShardedLookup.apply(
        part.to_local(grad_placements=grad_placements(part, tokens)), tokens.to_local(),
        local_offset(part, 0), [mesh.get_group(i) for i in vocab])
    return from_local(rows, mesh, tokens.placements, tuple(tokens.shape) + (table.shape[1],))
