"""Dispatch between the CUDA kernels and their plain versions.

The device of the tensors decides, and nothing else: a CUDA tensor
launches the kernel (or the call raises), a CPU tensor runs the plain
PyTorch version, and a meta tensor (a dry run, ``launch/dryrun.py``)
goes the kernel's way, through the same autograd Function, to the
kernel operator's fake implementation, which gives the outputs' shapes
and dtypes and computes nothing: never the plain version's arithmetic
in the kernel's place. There is no fallback from one to the other.

Each kernel's entry here carries ``launches``, a plain int that counts
the kernel launches made through it, so a run can show that its main
path went through the kernel. A meta call launches nothing and is not
counted, nor is an empty batch's (a rank that holds no row of a
micro-batch), for which the kernel is not launched.

A CUDA attention call always goes through ``FlashAttentionFn`` (K1
forward, tensor-op backward) and a CUDA SSD scan through ``SSDScanFn``
(K2 forward, the autograd of ``ssd_chunked`` as backward). Each records
a graph only when a gradient is taken (grad mode on and an input that
requires grad); its backward launches no kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd_mod


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Attention (B,S,H,hd) x (B,T,K,hd) x2 -> (B,S,H,hd), H % K == 0.

    Query head h reads KV head h // (H // K); K == H is the full-H form.
    Query row i is global row ``q_offset + i`` of the causal mask (a
    rank's block of rows against the full k/v); a causal call at an
    offset with ``q_offset + S > T`` is refused (``ref.check_q_offset``).
    CUDA: K1 (``csrc/flash_attention.cu``) through ``FlashAttentionFn``.
    Meta: the same Function, whose K1 operator only shapes the output.
    CPU: ``ref.attention_ref``, whose autograd is the reference's.
    """
    if q.device.type in ("cuda", "meta"):
        out = fa.FlashAttentionFn.apply(q, k, v, causal, q_offset)
        attention.launches += q.device.type == "cuda" and q.numel() > 0
        return out
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    raise ValueError(f"attention runs on cuda or cpu tensors, not {q.device}")


attention.launches = 0


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, chunk: int,
        init_state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y (b,s,h,p) in x's dtype, final_state (b,h,p,n) f32).

    CUDA: K2 (``csrc/ssd_scan.cu``) through ``SSDScanFn``. Meta: the same
    Function, whose K2 operator only shapes the outputs. CPU:
    ``models.ssm.ssd_chunked``, the JAX package's ``ops.ssd(impl="jnp")``
    path, whose autograd is the reference's.
    """
    if x.device.type in ("cuda", "meta"):
        out = ssd_mod.SSDScanFn.apply(x, dt, A, B, C, chunk, init_state)
        ssd.launches += x.device.type == "cuda" and x.shape[0] > 0
        return out
    if x.device.type == "cpu":
        from repro_torch.models.ssm import ssd_chunked   # models.ssm imports this module
        return ssd_chunked(x, dt.float(), A, B, C, chunk, init_state=init_state)
    raise ValueError(f"ssd runs on cuda or cpu tensors, not {x.device}")


ssd.launches = 0
