"""K1 flash attention forward: the launcher of the Hopper kernel, and its
autograd Function.

The kernel, ``csrc/flash_attention.cu``, replaces the JAX package's
Pallas kernel ``repro/kernels/flash_attention.py::_kernel``; its note
gives the design and the bound. This module checks the inputs, allocates
the output and launches it on PyTorch's current stream. k and v come in
the model's grouped form (B, T, K, hd), H % K == 0: query head h reads
KV head h // (H // K), and K == H is the full-H call. ``q_offset`` makes
query row i global row ``q_offset + i`` of the causal mask: a rank's
block of rows under q-sequence tensor parallelism, against the full k/v
(without it, such a rank would mask the wrong keys). bf16 inputs run the
tensor-core kernel, f32 inputs the scalar one. It takes CUDA tensors
only; ``ops.attention`` sends a CPU tensor to the plain version,
``ref.attention_ref``.

``FlashAttentionFn`` puts K1 under a gradient: its forward launches K1
and its backward is ``ref.attention_bwd``, tensor ops that recompute P
(the Pallas kernel has no backward; the JAX model trains through XLA's
autodiff of its jnp attention).

The forward launch is bound as the operator ``repro_torch::k1_fwd``
(``torch.library``), which ``FlashAttentionFn.forward`` calls:
its CUDA implementation is ``flash_attention`` below, its fake
implementation gives a meta tensor the output's shape and dtype (a dry
run traces the model on the meta device and launches nothing), and its
FLOP formula (``flops``) tells ``torch.utils.flop_counter`` what the
kernel computes. It has no CPU implementation: a CPU tensor never
reaches it (``ops.attention`` sends one to the plain version).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _launcher():
    lib = _build.load("flash_attention")
    fn = lib.k1_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.k1_error_string.argtypes = [ctypes.c_int]
    lib.k1_error_string.restype = ctypes.c_char_p
    return fn, lib.k1_error_string


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
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd), k/v: (B, T, K, hd) with H % K == 0 -> (B, S, H, hd).

    Query row i is global row ``q_offset + i`` of the causal mask.
    Launches K1 on the current stream and returns without synchronising.
    Raises if the inputs are not ones the kernel takes (a causal block at
    an offset past the last key among them, ``ref.check_q_offset``), if
    the kernel cannot be built, or if the launch is refused. An empty q
    (a rank that holds no row of a micro-batch) launches nothing.
    """
    _check_inputs(q, k, v)
    ref.check_q_offset(q.shape[1], k.shape[1], q_offset, causal)
    out = torch.empty_like(q)
    if not out.numel():
        return out
    fn, error_string = _launcher()
    B, S, H, hd = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, k.shape[1], H, k.shape[2], hd, int(q.dtype == torch.bfloat16),
                int(causal), q_offset if causal else 0, stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {rc} "
                           f"({error_string(rc).decode()})")
    return out


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


# the operator of one K1 forward launch: its CUDA implementation is
# ``flash_attention``, its fake one shapes a meta tensor's output. Bound
# through ``torch.library.Library`` (``custom_op``'s extra Python layers
# cost the host more on each call); the library must stay alive.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("k1_fwd(Tensor q, Tensor k, Tensor v, bool causal, int q_offset) -> Tensor")


def _k1_fwd_cuda(q, k, v, causal, q_offset):
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset)


_LIB.impl("k1_fwd", _k1_fwd_cuda, "CUDA")


@torch.library.register_fake("repro_torch::k1_fwd")
def _k1_fwd_fake(q, k, v, causal, q_offset):
    _check_shapes(q, k, v)
    ref.check_q_offset(q.shape[1], k.shape[1], q_offset, causal)
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.k1_fwd)
def _k1_fwd_flops(q_shape, k_shape, v_shape, causal, q_offset, *, out_shape=None, **kw):
    B, S, H, hd = q_shape
    return flops(B, S, k_shape[1], H, hd, causal, q_offset)


class FlashAttentionFn(torch.autograd.Function):
    """K1 forward, tensor-op backward (``ref.attention_bwd``).

    ``apply(q, k, v, causal, q_offset=0)`` launches K1 once (through
    ``repro_torch::k1_fwd``; on meta tensors it only shapes the output)
    and saves q, k, v and the output for the backward, which launches no K1.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int = 0):
        out = torch.ops.repro_torch.k1_fwd(q, k, v, causal, q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = ref.attention_bwd(q, k, v, out, dout, causal=ctx.causal,
                                       q_offset=ctx.q_offset)
        return dq, dk, dv, None, None
