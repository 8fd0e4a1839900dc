"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

- ``csrc/*.cu``: kernel sources, built with ``nvcc`` at first use
  (``_build.py``) into ``kernels/_build/`` and loaded with ``ctypes``.
- ``ref.py``: the plain PyTorch version of each kernel.
- ``ops.py``: dispatch. A CUDA tensor launches the kernel; a CPU tensor
  runs the plain version.
"""
