"""K1 flash attention: the launchers of the Hopper kernels, forward and
backward, and their autograd Function.

The forward kernel, ``csrc/flash_attention.cu``, replaces the JAX
package's Pallas kernel ``repro/kernels/flash_attention.py::_kernel``;
its note gives the design and the bound. This module checks the inputs,
allocates the outputs and launches it on PyTorch's current stream. k and
v come in the model's grouped form (B, T, K, hd), H % K == 0: query head
h reads KV head h // (H // K), and K == H is the full-H call.
``q_offset`` makes query row i global row ``q_offset + i`` of the causal
mask: a rank's block of rows under q-sequence tensor parallelism, against
the full k/v (without it, such a rank would mask the wrong keys). bf16
inputs run the tensor-core kernel, f32 inputs the scalar one. It takes
CUDA tensors only; ``ops.attention`` sends a CPU tensor to the plain
version, ``ref.attention_ref``.

``FlashAttentionFn`` puts K1 under a gradient. Its backward, for bf16 at
hd 32, 64 and 128, is K1's backward kernel (same source; it replaces no
TPU kernel: the Pallas kernel has no backward and the JAX model trains
through XLA's autodiff of its jnp attention), which reads each row's
log-sum-exp that the forward then writes. f32 (the consistency checks)
and hd 256 take ``ref.attention_bwd``, tensor ops that recompute P.

The launches are bound as the operators ``repro_torch::k1_fwd`` and
``repro_torch::k1_bwd`` (``torch.library``), which ``FlashAttentionFn``
calls: their CUDA implementations are ``flash_attention`` and
``flash_attention_bwd`` below, their fake implementations give meta
tensors the outputs' shapes and dtypes (a dry run traces the model on the
meta device and launches nothing), and their FLOP formulas (``flops``,
``bwd_flops``) tell ``torch.utils.flop_counter`` what the kernels compute.
They have no CPU implementation: a CPU tensor never reaches them
(``ops.attention`` sends one to the plain version).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
# the backward kernel's head dims: at hd 256 a warp's dK and dV accumulators
# would take 256 registers a thread, so hd 256 keeps ``ref.attention_bwd``
BWD_HEAD_DIMS = (32, 64, 128)


@functools.cache
def _launcher():
    lib = _build.load("flash_attention")
    fwd = lib.k1_flash_attention_fwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
    fwd.restype = ctypes.c_int
    bwd = lib.k1_flash_attention_bwd
    bwd.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    lib.k1_bwd_stats_rows.argtypes = [ctypes.c_int]
    lib.k1_bwd_stats_rows.restype = ctypes.c_int
    lib.k1_error_string.argtypes = [ctypes.c_int]
    lib.k1_error_string.restype = ctypes.c_char_p
    return fwd, (bwd, lib.k1_bwd_stats_rows), lib.k1_error_string


def _raise_unless_launched(rc: int, what: str, error_string) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({error_string(rc).decode()})")


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ValueError unless the kernel takes these tensors."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"K1 takes CUDA tensors; {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"K1 takes contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"K1 takes 16-byte aligned tensors; {name} is not")
    if not (q.device == k.device == v.device):
        raise ValueError("K1 takes q, k and v on one device")
    _check_shapes(q, k, v)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ValueError unless the kernel takes these dtypes and shapes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise ValueError(f"K1 takes float32 or bfloat16; {name} is {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"K1 takes 4-d (B, S|T, H|K, hd) tensors; {name} has shape "
                             f"{tuple(t.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"K1 takes one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"K1 takes head_dim in {HEAD_DIMS}; got {hd}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"K1 shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if min(S, H, k.shape[1], k.shape[2]) == 0:   # an empty batch launches nothing
        raise ValueError(f"K1 takes non-empty sequences and heads; q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"K1 takes a number of KV heads that divides H; "
                         f"H={H}, K={k.shape[2]}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    lse: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, S, H, hd), k/v: (B, T, K, hd) with H % K == 0 -> (B, S, H, hd).

    Query row i is global row ``q_offset + i`` of the causal mask.
    ``lse``, a contiguous float32 (B, H, S) tensor (bf16 inputs only),
    takes each row's log-sum-exp of the scaled scores, which the backward
    kernel reads; without it the launch writes none.
    Launches K1 on the current stream and returns without synchronising.
    Raises if the inputs are not ones the kernel takes (a causal block at
    an offset past the last key among them, ``ref.check_q_offset``), if
    the kernel cannot be built, or if the launch is refused. An empty q
    (a rank that holds no row of a micro-batch) launches nothing.
    """
    _check_inputs(q, k, v)
    ref.check_q_offset(q.shape[1], k.shape[1], q_offset, causal)
    if lse is not None:
        _check_lse(q, lse)
    out = torch.empty_like(q)
    if not out.numel():
        return out
    fwd, _, error_string = _launcher()
    B, S, H, hd = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, k.shape[1], H, k.shape[2], hd, int(q.dtype == torch.bfloat16),
                 int(causal), q_offset if causal else 0,
                 None if lse is None else lse.data_ptr(), stream)
    _raise_unless_launched(rc, "K1", error_string)
    return out


def _check_lse(q: torch.Tensor, lse: torch.Tensor) -> None:
    B, S, H, _ = q.shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"K1 writes the log-sum-exp for bfloat16 inputs only; q is {q.dtype}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"K1's log-sum-exp is a contiguous float32 (B, H, S) = {(B, H, S)} "
                         f"tensor on q's device; got {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}")


def backward_kernel_takes(q: torch.Tensor) -> bool:
    """Whether K1's backward kernel computes the gradients of a call on q:
    bfloat16 at a head dim in ``BWD_HEAD_DIMS``. Every other call (float32,
    hd 256) takes ``ref.attention_bwd``."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in BWD_HEAD_DIMS


def _check_bwd(q, k, v, out, dout, lse) -> None:
    """Raise ValueError unless the backward kernel takes these tensors."""
    if not backward_kernel_takes(q):
        raise ValueError(f"K1's backward takes bfloat16 at head_dim in {BWD_HEAD_DIMS}; "
                         f"q is {q.dtype} at {q.shape[-1]}")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"K1's backward takes {name} of q's shape and dtype; got "
                             f"{t.dtype} {tuple(t.shape)}")
    _check_lse(q, lse)


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        q_offset: int = 0):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` for the
    output ``out``, its gradient ``dout`` and the forward's ``lse``, by K1's
    backward kernels on the current stream (no synchronisation): dQ (and
    each row's delta = rowsum(dout * out)), then dK and dV, then, when
    H > K, the sum of each KV head's group. bfloat16, hd in
    ``BWD_HEAD_DIMS``; raises on anything else, as the forward does. An
    empty batch launches nothing."""
    _check_inputs(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"K1's backward takes a contiguous, 16-byte aligned {name} "
                             f"on q's device")
    _check_bwd(q, k, v, out, dout, lse)
    ref.check_q_offset(q.shape[1], k.shape[1], q_offset, causal)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if not q.numel():
        return dq, dk, dv
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    _, (bwd, stats_rows), error_string = _launcher()
    f32 = dict(dtype=torch.float32, device=q.device)
    stats = torch.empty((2, B * H, stats_rows(S)), **f32)
    parts = (None, None) if H == K else (torch.empty((B, T, H, hd), **f32),
                                         torch.empty((B, T, H, hd), **f32))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = bwd(*(t.data_ptr() for t in (q, k, v, out, dout, lse, dq, dk, dv, stats)),
                 *(None if t is None else t.data_ptr() for t in parts),
                 B, S, T, H, K, hd, int(causal), q_offset if causal else 0, stream)
    _raise_unless_launched(rc, "K1 backward", error_string)
    return dq, dk, dv


def live_pairs(S: int, T: int, causal: bool, q_offset: int = 0) -> int:
    """The (query, key) pairs K1 computes: S * T, or under the causal mask
    the keys row i (global row ``q_offset + i``) keeps, min(q_offset + i + 1, T)."""
    if not causal:
        return S * T
    m = max(0, min(S, T - q_offset))          # the rows whose bound lies inside T
    return m * q_offset + m * (m + 1) // 2 + (S - m) * T


def flops(B: int, S: int, T: int, H: int, hd: int, causal: bool, q_offset: int = 0) -> int:
    """K1's operations: 2 for each multiply-add of q.k and of p.v, over the
    live pairs of every query head (the tiles past the causal bound skipped)."""
    return 4 * B * H * hd * live_pairs(S, T, causal, q_offset)


def bwd_flops(B: int, S: int, T: int, H: int, hd: int, causal: bool,
              q_offset: int = 0) -> int:
    """The backward's operations: the five products of a flash backward (q.k
    recomputed, dV, dP, dQ, dK) over the live pairs, 2.5 times ``flops``.
    The kernel computes q.k and dP twice (once for dQ, once for dK and dV),
    seven products in all: this counts the work, not the kernel's way."""
    return 5 * flops(B, S, T, H, hd, causal, q_offset) // 2


# the operators of one K1 forward launch and of one backward: their CUDA
# implementations are ``flash_attention`` and ``flash_attention_bwd``,
# their fake ones shape a meta tensor's outputs. Bound through
# ``torch.library.Library`` (``custom_op``'s extra Python layers cost the
# host more on each call); the library must stay alive. k1_fwd writes the
# log-sum-exp into ``lse`` when it is given.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("k1_fwd(Tensor q, Tensor k, Tensor v, bool causal, int q_offset, "
            "Tensor(a!)? lse=None) -> Tensor")
_LIB.define("k1_bwd(Tensor q, Tensor k, Tensor v, Tensor out, Tensor dout, Tensor lse, "
            "bool causal, int q_offset) -> (Tensor, Tensor, Tensor)")


def _k1_fwd_cuda(q, k, v, causal, q_offset, lse=None):
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset, lse=lse)


def _k1_bwd_cuda(q, k, v, out, dout, lse, causal, q_offset):
    return flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, q_offset=q_offset)


_LIB.impl("k1_fwd", _k1_fwd_cuda, "CUDA")
_LIB.impl("k1_bwd", _k1_bwd_cuda, "CUDA")


@torch.library.register_fake("repro_torch::k1_fwd")
def _k1_fwd_fake(q, k, v, causal, q_offset, lse=None):
    _check_shapes(q, k, v)
    ref.check_q_offset(q.shape[1], k.shape[1], q_offset, causal)
    if lse is not None:
        _check_lse(q, lse)
    return torch.empty_like(q)


@torch.library.register_fake("repro_torch::k1_bwd")
def _k1_bwd_fake(q, k, v, out, dout, lse, causal, q_offset):
    _check_shapes(q, k, v)
    _check_bwd(q, k, v, out, dout, lse)
    ref.check_q_offset(q.shape[1], k.shape[1], q_offset, causal)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.k1_fwd)
def _k1_fwd_flops(q_shape, k_shape, v_shape, causal, q_offset, lse_shape=None, *,
                  out_shape=None, **kw):
    B, S, H, hd = q_shape
    return flops(B, S, k_shape[1], H, hd, causal, q_offset)


@register_flop_formula(torch.ops.repro_torch.k1_bwd)
def _k1_bwd_flops(q_shape, k_shape, v_shape, o_shape, dout_shape, lse_shape, causal,
                  q_offset, *, out_shape=None, **kw):
    B, S, H, hd = q_shape
    return bwd_flops(B, S, k_shape[1], H, hd, causal, q_offset)


class FlashAttentionFn(torch.autograd.Function):
    """K1 forward; K1's backward kernel, or ``ref.attention_bwd``.

    ``apply(q, k, v, causal, q_offset=0)`` launches K1 once (through
    ``repro_torch::k1_fwd``; on meta tensors it only shapes the output)
    and saves q, k, v and the output for the backward. The input's dtype
    and head dim choose the backward (``backward_kernel_takes``): bf16 at
    hd 32, 64 or 128 runs the backward kernel (``repro_torch::k1_bwd``),
    for which the forward, when an input needs a gradient, also writes
    and saves each row's log-sum-exp; float32 (the consistency checks)
    and hd 256 (whose accumulators do not fit the kernel's registers)
    run ``ref.attention_bwd``, tensor ops that recompute P. Neither is a
    fallback: a launch the kernel refuses raises. On CUDA each backward
    counts into ``ops.attention.bwd_launches`` or ``ops.attention.bwd_plain``.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int = 0):
        lse = None
        if any(ctx.needs_input_grad[:3]) and backward_kernel_takes(q):
            lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
                              device=q.device)
            out = torch.ops.repro_torch.k1_fwd(q, k, v, causal, q_offset, lse)
        else:
            out = torch.ops.repro_torch.k1_fwd(q, k, v, causal, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import ops   # ops imports this module
        q, k, v, out, lse = ctx.saved_tensors
        on_card = q.device.type == "cuda"
        if backward_kernel_takes(q):
            dq, dk, dv = torch.ops.repro_torch.k1_bwd(q, k, v, out, dout.contiguous(), lse,
                                                      ctx.causal, ctx.q_offset)
            ops.attention.bwd_launches += on_card and q.numel() > 0
        else:
            dq, dk, dv = ref.attention_bwd(q, k, v, out, dout, causal=ctx.causal,
                                           q_offset=ctx.q_offset)
            ops.attention.bwd_plain += on_card
        return dq, dk, dv, None, None
