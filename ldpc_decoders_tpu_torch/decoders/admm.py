"""Batched ADMM LP decoding (counterpart of
``ldpc_decoders_tpu.decoders.admm``).

``ADMMDecoder.decode(llr)`` runs the whole loop through
:func:`~ldpc_decoders_tpu_torch.ops.admm_kernel.admm_decode`: the CUDA
kernel for CUDA tensors, its plain PyTorch version for CPU tensors. The
semantics are the JAX package's (``ops/admm_kernel.py`` spells them out):
``max_iter <= 0`` means "run to convergence", bounded by ``iter_cap``; the
output goes through ``pseudo_to_cw`` (a hard 0.5 threshold, or with
``allow_pseudo`` a snap to 0/1 only within 1e-8, so fractional
pseudo-codewords stay fractional and count as bit errors); ``iters``
follows the reference's histogram convention (k - 1 for a word that
converged at its k-th update, the cap otherwise).

The port has one route per device, so the same kernel serves
``allow_pseudo`` (it also returns the fractional x) and graphs of
non-uniform variable degree; the JAX package sends both to its XLA route.
The JAX package's ``presort`` has no counterpart: it aligns its kernel's
per-block exit with per-word cost, and the CUDA kernel's exit is per word
(the CLI accepts ``--presort`` and drops it).
"""

from __future__ import annotations

import torch

from ldpc_decoders_tpu_torch.ops.admm_kernel import admm_decode
from ldpc_decoders_tpu_torch.ops.graph import TannerGraph, bp_tables
from ldpc_decoders_tpu_torch.utils.math import pseudo_to_cw_tensor


class ADMMDecoder:
    """Batched ADMM decoder. decode(llr [B, V]) -> (x_hat, iters)."""

    id_keys = ["mu", "eps", "max_iter", "allow_pseudo"]
    track_iter_hist = True  # the harness aggregates the iteration histogram

    def __init__(self, graph: TannerGraph, mu: float = 3.0, eps: float = 1e-5,
                 max_iter: int = 10, allow_pseudo: bool = False,
                 iter_cap: int = 2000, perm: str = "auto",
                 device=None, **_):
        if perm != "auto":
            raise NotImplementedError(
                f"perm={perm!r}: the port has one route per device (kernel "
                "on CUDA, plain PyTorch on the CPU); the JAX package's "
                "gather/matmul/pallas routes are not ported (ROADMAP A.4)")
        self.graph = graph if device is None else graph.to(device)
        self.mu = float(mu)
        self.eps = float(eps)
        self.max_iter = int(max_iter)
        self.allow_pseudo = bool(allow_pseudo)
        self.iter_cap = self.max_iter if self.max_iter > 0 else int(iter_cap)
        self.tables = bp_tables(self.graph)

    def decode(self, llr: torch.Tensor) -> tuple:
        x_hat, iters, x = admm_decode(
            llr.to(torch.float32).contiguous(), self.tables, mu=self.mu,
            eps=self.eps, max_iter=self.iter_cap, n_edge=self.graph.n_edge)
        if self.allow_pseudo:
            return pseudo_to_cw_tensor(x, True), iters
        return x_hat, iters
