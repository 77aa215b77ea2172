"""Graph tables and kernels (CUDA sources in ``../csrc``)."""
