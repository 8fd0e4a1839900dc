"""PyTorch/CUDA port of the JAX package ``repro`` (served on an NVIDIA H100).

The port mirrors the JAX package's module names and public layouts
((in, out) weight matrices, stacked ``blocks`` with a leading L axis, a
(L, B, T, K, hd) KV cache), so a reader finds each counterpart by name
and the parity tests compare leaf to leaf. It imports ``torch`` and
never ``jax`` or anything under ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Every kernel that the JAX package wrote in Pallas is a CUDA kernel here
(``kernels/csrc``); on a CUDA tensor the kernel builds and launches or
the call raises, and only a CPU tensor takes the plain PyTorch version.
"""
