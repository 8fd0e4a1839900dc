"""Dispatch between the CUDA kernels and their plain versions.

The device of the tensors decides, and nothing else: a CUDA tensor
launches the kernel (or the call raises), a CPU tensor runs the plain
PyTorch version. There is no fallback from one to the other.

Each kernel's entry here carries ``launches``, a plain int that counts
the kernel launches made through it, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """Full-H attention (B,S,H,hd) x (B,T,H,hd) x2 -> (B,S,H,hd).

    CUDA: K1 (``csrc/flash_attention.cu``). CPU: ``ref.attention_ref``.
    """
    if q.device.type == "cuda":
        out = fa.flash_attention(q, k, v, causal=causal)
        attention.launches += 1
        return out
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    raise ValueError(f"attention runs on cuda or cpu tensors, not {q.device}")


attention.launches = 0
