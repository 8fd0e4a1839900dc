"""K2 Mamba2 chunked SSD scan: the launcher of the Hopper kernel.

The kernel, ``csrc/ssd_scan.cu``, replaces the JAX package's Pallas
kernel ``repro/kernels/ssd_scan.py::_kernel``; its note gives the design
and the bound. This module checks the inputs, allocates the outputs
(and the C.B^T scratch of the scalar kernel), and launches it on PyTorch's current stream. The
dtypes alone choose the kernel (``kernel_path``): bf16 x with bf16 B/C
runs the tensor-core scan, any f32 operand the scalar one. It takes
CUDA tensors only; ``ops.ssd`` sends a CPU tensor to the plain version,
``models.ssm.ssd_chunked``.

``SSDScanFn`` puts K2 under a gradient: its forward launches K2 and its
backward is the autograd of ``models.ssm.ssd_chunked``, recomputed from
the saved inputs in tensor ops (the Pallas kernel has no backward; the
JAX model trains through XLA's autodiff of that jnp scan).

The forward launch is bound as the operator ``repro_torch::k2_fwd``
(``torch.library``), which ``SSDScanFn.forward`` calls: its
CUDA implementation is ``ssd_scan`` below, its fake implementation gives
meta tensors the outputs' shapes and dtypes (a dry run launches
nothing), and its FLOP formula (``flops``) tells
``torch.utils.flop_counter`` what the kernel computes. It has no CPU
implementation: ``ops.ssd`` sends a CPU tensor to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 32, 64)      # P
MAX_CHUNK = 128                  # also the largest N
DTYPES = (torch.float32, torch.bfloat16)


def kernel_chunk(S: int, chunk: int) -> int:
    """The chunk K2 runs a scan of S positions at when ``chunk`` is asked
    for: the largest divisor of S that is not above min(chunk, MAX_CHUNK).

    The chunked scan computes the same function at any chunk (the chunk
    changes only the rounding), so a chunk above K2's limit, which the
    JAX package's ``ssd_chunked`` runs, is served at this one. K2 itself
    still refuses a chunk above ``MAX_CHUNK``.
    """
    if S < 1 or chunk < 1:
        raise ValueError(f"kernel_chunk takes S >= 1 and chunk >= 1; got {S}, {chunk}")
    c = min(chunk, MAX_CHUNK, S)
    while S % c:
        c -= 1
    return c


def kernel_path(x_dtype: torch.dtype, bc_dtype: torch.dtype) -> str:
    """The kernel a call with these dtypes runs: "mma" (tensor cores, bf16 x
    and bf16 B/C) or "scalar" (f32 FMAs, any f32 operand)."""
    return "mma" if x_dtype == bc_dtype == torch.bfloat16 else "scalar"


@functools.cache
def _launcher():
    lib = _build.load("ssd_scan")
    fn = lib.k2_ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.k2_error_string.argtypes = [ctypes.c_int]
    lib.k2_error_string.restype = ctypes.c_char_p
    return fn, lib.k2_error_string


def _check_inputs(x, dt, A, B, C, chunk, init_state) -> None:
    """Raise ValueError unless the kernel takes these tensors and this chunk."""
    _check_shapes(x, dt, A, B, C, chunk, init_state)
    named = [(n, t) for n, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C),
                                 ("init_state", init_state)) if t is not None]
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"K2 takes CUDA tensors; {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"K2 takes contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"K2 takes 16-byte aligned tensors; {name} is not")
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"K2 takes its tensors on one device; got {sorted(map(str, devices))}")


def _check_shapes(x, dt, A, B, C, chunk, init_state):
    """Raise ValueError unless the kernel takes these shapes, dtypes and this
    chunk; return (b, s, h, p, n)."""
    if x.dim() != 4:
        raise ValueError(f"K2 takes x of shape (b, s, h, p); got {tuple(x.shape)}")
    b, s, h, p = x.shape
    if min(s, h) == 0:                            # an empty batch launches nothing
        raise ValueError(f"K2 takes non-empty sequences and heads; x {tuple(x.shape)}")
    if p not in HEAD_DIMS:
        raise ValueError(f"K2 takes head_dim p in {HEAD_DIMS}; got {p}")
    if B.dim() != 3:
        raise ValueError(f"K2 takes B of shape (b, s, n); got {tuple(B.shape)}")
    n = B.shape[-1]
    if n % 4 or not 4 <= n <= MAX_CHUNK:
        raise ValueError(f"K2 takes a state size n that is a multiple of 4 in "
                         f"[4, {MAX_CHUNK}]; got {n}")
    if not isinstance(chunk, int) or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"K2 takes a chunk in [1, {MAX_CHUNK}]; got {chunk}")
    if s % chunk:
        raise ValueError(f"K2 takes a chunk that divides s; {chunk} does not divide {s}")
    for name, t, dtypes, shape in (
            ("x", x, DTYPES, (b, s, h, p)), ("dt", dt, (torch.float32,), (b, s, h)),
            ("A", A, (torch.float32,), (h,)), ("B", B, DTYPES, (b, s, n)),
            ("C", C, (B.dtype,), (b, s, n)),
            ("init_state", init_state, (torch.float32,), (b, h, p, n))):
        if t is None:
            continue
        if t.dtype not in dtypes:
            raise ValueError(f"K2 takes {name} in {dtypes}; got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"K2 takes {name} of shape {tuple(shape)}; got {tuple(t.shape)}")
    return b, s, h, p, n


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x: (b, s, h, p), dt: (b, s, h) f32, A: (h,) f32,
    B, C: (b, s, n), init_state: (b, h, p, n) f32 or None (zero).

    Returns (y (b, s, h, p) in x's dtype, final_state (b, h, p, n) f32).
    Launches K2 on the current stream and returns without synchronising.
    Raises if the inputs are not ones the kernel takes, if the kernel
    cannot be built, or if the launch is refused. An empty batch (a rank
    that holds no row of a micro-batch) launches nothing.
    """
    _check_inputs(x, dt, A, B, C, chunk, init_state)
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    final_state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if not b:
        return y, final_state
    fn, error_string = _launcher()
    cb = (torch.empty((b, s // chunk, chunk, chunk), dtype=torch.float32, device=x.device)
          if kernel_path(x.dtype, B.dtype) == "scalar" else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                None if init_state is None else init_state.data_ptr(),
                None if cb is None else cb.data_ptr(), y.data_ptr(), final_state.data_ptr(),
                b, s, h, p, n, chunk, int(x.dtype == torch.bfloat16),
                int(B.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {rc} "
                           f"({error_string(rc).decode()})")
    return y, final_state


def flops(b: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """K2's operations: 2 for each multiply-add of C.B^T over each chunk's
    causal (i, j) pairs (once per batch row and chunk: B and C have no head
    axis), and per batch row, head and chunk of the intra-chunk term over
    the same pairs and P, and of the carried-state output term and the
    state update (chunk * N * P each)."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    return 2 * b * nc * (pairs * n + h * (pairs * p + 2 * chunk * n * p))


# the operator of one K2 launch: its CUDA implementation is ``ssd_scan``,
# its fake one shapes meta tensors' outputs (bound as K1's is,
# ``flash_attention._LIB``); the library must stay alive.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("k2_fwd(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, int chunk, "
            "Tensor? init_state) -> (Tensor, Tensor)")


def _k2_fwd_cuda(x, dt, A, B, C, chunk, init_state):
    return ssd_scan(x, dt, A, B, C, chunk=chunk, init_state=init_state)


_LIB.impl("k2_fwd", _k2_fwd_cuda, "CUDA")


@torch.library.register_fake("repro_torch::k2_fwd")
def _k2_fwd_fake(x, dt, A, B, C, chunk, init_state):
    b, s, h, p, n = _check_shapes(x, dt, A, B, C, chunk, init_state)
    return torch.empty_like(x), x.new_empty((b, h, p, n), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.k2_fwd)
def _k2_fwd_flops(x_shape, dt_shape, A_shape, B_shape, C_shape, chunk, init_shape, *,
                  out_shape=None, **kw):
    b, s, h, p = x_shape
    return flops(b, s, h, p, B_shape[-1], chunk)


class SSDScanFn(torch.autograd.Function):
    """K2 forward, tensor-op backward (the autograd of ``ssd_chunked``).

    ``apply(x, dt, A, B, C, chunk, init_state)`` launches K2 once
    (through ``repro_torch::k2_fwd``; on meta tensors it only shapes the
    outputs) and saves its inputs; the backward launches no K2. It recomputes
    ``models.ssm.ssd_chunked`` from the saved inputs under a gradient and
    returns ``torch.autograd.grad`` of it, each gradient in its input's
    dtype (None for ``init_state`` when there is none). The final state's
    gradient may be None (a train step never uses the state).
    """

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int, init_state):
        y, final_state = torch.ops.repro_torch.k2_fwd(x, dt, A, B, C, chunk, init_state)
        ctx.save_for_backward(x, dt, A, B, C, init_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final_state

    @staticmethod
    def backward(ctx, dy, dfinal):
        from repro_torch.models.ssm import ssd_chunked   # models.ssm imports this module
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_(True) for t in saved]
        with torch.enable_grad():
            y, final_state = ssd_chunked(*inputs[:5], ctx.chunk, init_state=inputs[5])
        outs = [(o, g) for o, g in ((y, dy), (final_state, dfinal)) if g is not None]
        grads = iter(torch.autograd.grad([o for o, _ in outs],
                                         [t for t in inputs if t is not None],
                                         [g for _, g in outs], materialize_grads=True))
        dx, ddt, dA, dB, dC, dinit = (None if t is None else next(grads) for t in inputs)
        return dx, ddt, dA, dB, dC, None, dinit
