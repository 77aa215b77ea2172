"""Batched LLR-domain belief propagation (counterpart of
``ldpc_decoders_tpu.decoders.bp``): sum-product (SPA) and min-sum (MSA).

``BPDecoder(variant).decode(llr)`` runs the whole decode loop through
:func:`~ldpc_decoders_tpu_torch.ops.spa_kernel.spa_decode` (SPA) or
:func:`~ldpc_decoders_tpu_torch.ops.msa_kernel.msa_decode` (MSA): the CUDA
kernel for CUDA tensors, its plain PyTorch version for CPU tensors.
Messages are bf16 or f32, as ``msg_dtype`` says — never swapped behind the
caller's back. Semantics are the JAX package's: ``check_init`` (the biAWGN
factories set False), the per-word done freeze, iteration counts,
``max_iter <= 0`` meaning "run to convergence", bounded by ``iter_cap``,
``decode_multi_cap`` (the decisions at several iteration caps from one
pass), and SPA's ``inf_policy``: "reference" (the default) reproduces the
reference decoder's float64 inf/NaN cascade, which the committed SPA
goldens depend on; "saturate" is the clean decoder. MSA forces
"saturate".
"""

from __future__ import annotations

import torch

from ldpc_decoders_tpu_torch.ops.caps import check_caps
from ldpc_decoders_tpu_torch.ops.graph import TannerGraph, bp_tables
from ldpc_decoders_tpu_torch.ops.msa_kernel import (  # noqa: F401
    MSG_DTYPES,
    msa_check_rows,
    msa_decode,
)
from ldpc_decoders_tpu_torch.ops.spa_kernel import (  # noqa: F401
    INF_POLICIES,
    INF_S,
    LLR_CLIP,
    NAN_S,
    PHI_EPS,
    _INF_MIN,
    _NAN_MIN,
    phi,
    spa_check_rows,
    spa_check_rows_ref,
    spa_decode,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class BPDecoder:
    """Batched SPA/MSA decoder over a compiled Tanner graph.

    ``decode(llr)``: llr [B, V] on ``device`` -> (x_hat [B, V] int32,
    iters [B] int32)."""

    id_keys = ["max_iter"]

    def __init__(self, graph: TannerGraph, variant: str = "SPA",
                 max_iter: int = 10, iter_cap: int = 1000,
                 msg_dtype=torch.float32, perm: str = "auto",
                 check_init: bool = True, inf_policy: str = "reference",
                 device=None, **_):
        if variant not in ("SPA", "MSA"):
            raise ValueError(f"unknown BP variant {variant!r}")
        if inf_policy not in INF_POLICIES:
            raise ValueError(f"unknown inf_policy {inf_policy!r}")
        if perm != "auto":
            raise NotImplementedError(
                f"perm={perm!r}: the port has one route per device (kernel "
                "on CUDA, plain PyTorch on the CPU); the JAX package's "
                "incidence/matmul/gather routes are not ported (ROADMAP A.4)")
        msg_dtype = _DTYPES.get(msg_dtype, msg_dtype)
        if msg_dtype not in MSG_DTYPES:
            raise ValueError(f"msg_dtype must be bfloat16 or float32, "
                             f"not {msg_dtype}")
        self.device = device
        self.variant = variant
        self.inf_policy = inf_policy if variant == "SPA" else "saturate"
        self.check_init = bool(check_init)
        self.max_iter = int(max_iter)
        self.iter_cap = self.max_iter if self.max_iter > 0 else int(iter_cap)
        self.msg_dtype = msg_dtype
        self.set_graph(graph)

    def set_graph(self, graph: TannerGraph) -> None:
        """Decode on ``graph`` from now on (an ensemble member swap): its
        tables go to the decoder's device; nothing is rebuilt, since the
        kernels take their tables as arguments."""
        self.graph = graph if self.device is None else graph.to(self.device)
        self.tables = bp_tables(self.graph)

    def _decode(self, llr: torch.Tensor, max_iter: int, caps) -> tuple:
        kw = dict(max_iter=max_iter, check_init=self.check_init,
                  msg_dtype=self.msg_dtype, caps=caps)
        llr = llr.to(torch.float32).contiguous()
        if self.variant == "MSA":
            return msa_decode(llr, self.tables, **kw)
        return spa_decode(llr, self.tables, inf_policy=self.inf_policy, **kw)

    def decode(self, llr: torch.Tensor) -> tuple:
        return self._decode(llr, self.iter_cap, None)

    def decode_multi_cap(self, llr: torch.Tensor, caps) -> tuple:
        """One decode pass, decisions at every iteration cap in ``caps``
        (ascending positive ints). A word's trajectory does not depend on
        the cap — decisions freeze once the syndrome passes — so one pass
        bounded by ``caps[-1]`` snapshots them: ``x_hats[k]`` is bit for
        bit ``decode`` at ``max_iter=caps[k]`` and ``iters[k] =
        min(iters, caps[k])``. Returns (x_hats [K, B, V] int32,
        iters [K, B] int32)."""
        caps = check_caps(caps, caps[-1])
        x_hats, iters = self._decode(llr, caps[-1], caps)
        caps_t = torch.tensor(caps, dtype=torch.int32, device=iters.device)
        return x_hats, torch.minimum(iters[None], caps_t[:, None])
