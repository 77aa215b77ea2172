"""Batched ternary-message SPA for the binary erasure channel (counterpart
of ``ldpc_decoders_tpu.decoders.bec_spa``).

``BECSPADecoder.decode(y)`` runs the whole peeling loop through
:func:`~ldpc_decoders_tpu_torch.ops.bec_kernel.bec_spa_decode`: the CUDA
kernel for CUDA tensors, its plain PyTorch version for CPU tensors.
Channel symbols are {0, 1, 2} with 2 the erasure; a word stops when it is
decoded, caught in a stopping set, or at ``max_iter`` (``max_iter <= 0``
runs to convergence, bounded by ``iter_cap``). The dynamics are integer
exact, so the port is bit-equal to the JAX package on every route.
"""

from __future__ import annotations

import torch

from ldpc_decoders_tpu_torch.ops.bec_kernel import ERASURE, bec_spa_decode  # noqa: F401
from ldpc_decoders_tpu_torch.ops.caps import check_caps
from ldpc_decoders_tpu_torch.ops.graph import TannerGraph, bp_tables


class BECSPADecoder:
    """Batched erasure-channel SPA. ``decode(y [B, V] in {0,1,2})`` ->
    (x_hat [B, V] int32 in {0,1,2}, iters [B] int32)."""

    id_keys = ["max_iter"]

    def __init__(self, graph: TannerGraph, max_iter: int = 10,
                 iter_cap: int = 1000, perm: str = "auto", device=None,
                 **_):
        if perm != "auto":
            raise NotImplementedError(
                f"perm={perm!r}: the port has one route per device (kernel "
                "on CUDA, plain PyTorch on the CPU); the JAX package's "
                "gather/pallas routes are not ported (ROADMAP A.4)")
        self.device = device
        self.max_iter = int(max_iter)
        self.iter_cap = self.max_iter if self.max_iter > 0 else int(iter_cap)
        self.set_graph(graph)

    def set_graph(self, graph: TannerGraph) -> None:
        """Decode on ``graph`` from now on (an ensemble member swap)."""
        self.graph = graph if self.device is None else graph.to(self.device)
        self.tables = bp_tables(self.graph)

    def decode(self, y: torch.Tensor) -> tuple:
        return bec_spa_decode(y.to(torch.int32).contiguous(), self.tables,
                              max_iter=self.iter_cap)

    def decode_multi_cap(self, y: torch.Tensor, caps) -> tuple:
        """One pass, symbols snapshotted at every iteration cap (erasure
        peeling freezes a word once decoded or caught in a stopping set,
        so plane k equals ``decode`` at ``max_iter=caps[k]``). Returns
        (x_hats [K, B, V] int32, iters [K, B] int32)."""
        caps = check_caps(caps, caps[-1])
        x_hats, iters = bec_spa_decode(y.to(torch.int32).contiguous(),
                                       self.tables, max_iter=caps[-1],
                                       caps=caps)
        caps_t = torch.tensor(caps, dtype=torch.int32, device=iters.device)
        return x_hats, torch.minimum(iters[None], caps_t[:, None])
