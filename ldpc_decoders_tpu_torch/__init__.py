"""ldpc_decoders_tpu_torch — the PyTorch / CUDA port of ``ldpc_decoders_tpu``.

The package mirrors the JAX package's module layout (codes, channels,
decoders, ops, harness, design, viz, main) with PyTorch idiom inside.
Plain tensor code is PyTorch; the fused decode loops are hand-written CUDA
C++ kernels for Hopper (``csrc/*.cu``), built with ``nvcc`` at first use
and bound with ``ctypes`` (``ops/_build.py`` and a wrapper per kernel).

CPU tensors take each kernel's plain PyTorch version; CUDA tensors launch
the kernel or raise — there is no silent fallback. The package never
imports ``jax`` or ``ldpc_decoders_tpu``; the JAX package is the reference
the tests hold it against.
"""

__version__ = "0.1.0"

from ldpc_decoders_tpu_torch.codes import Code, get_code, get_code_names  # noqa: F401,E402
