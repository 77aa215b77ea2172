"""Ensemble BP: G same-shape member codes decoded together (counterpart of
``ldpc_decoders_tpu.decoders.bp_ensemble``).

``decode(llr [G, B, V]) -> (x_hat [G, B, V] int32, iters [G, B] int32)``.
Members differ only in their index tables, so each member is a
:class:`~ldpc_decoders_tpu_torch.decoders.bp.BPDecoder` (or
:class:`~ldpc_decoders_tpu_torch.decoders.bec_spa.BECSPADecoder`) of its
own, and a decode is one call of that member's decoder per member: on a
CUDA tensor one launch of ``msa_decode`` / ``spa_decode`` /
``bec_spa_decode`` per member with the member's tables, on a CPU tensor
their plain versions. A member's decisions are therefore bit for bit its
own decoder's. (The JAX package stacks one-hot permutation matrices on a
leading axis and ``vmap``s one program over them; that is a device of the
TPU and is not copied.)

``decode(..., members=idx)`` decodes a subset: the leading axis then
indexes ``idx``. The joint runner uses it to stop decoding members that
have their ``min_wec``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ldpc_decoders_tpu_torch.decoders.bec_spa import BECSPADecoder
from ldpc_decoders_tpu_torch.decoders.bp import BPDecoder
from ldpc_decoders_tpu_torch.ops.graph import TannerGraph


def check_member_shapes(graphs) -> tuple:
    """All member graphs must share (C, V, Dc, Dv); edge counts may differ
    (an irregular draw's double edges cancel, the padded shapes stay)."""
    shapes = {(g.n_chk, g.n_var, g.max_chk_deg, g.max_var_deg)
              for g in graphs}
    if len(shapes) != 1:
        raise ValueError(f"ensemble members differ in shape: {shapes}")
    return next(iter(shapes))


class _Ensemble:
    """G member decoders of one shape behind one [G, B, V] decode."""

    def __init__(self, members: list, graphs: Sequence[TannerGraph]):
        check_member_shapes(graphs)
        self.members = members
        self.n_members = len(members)

    def decode(self, llr: torch.Tensor,
               members: Optional[Sequence[int]] = None) -> tuple:
        """llr [G, B, V] (symbols on the BEC) -> (x_hat [G, B, V],
        iters [G, B]); with ``members`` the leading axis indexes them."""
        idx = range(self.n_members) if members is None else members
        if llr.shape[0] != len(idx):
            raise ValueError(
                f"expected leading member axis {len(idx)}, got "
                f"{tuple(llr.shape)}")
        outs = [self.members[g].decode(llr[i]) for i, g in enumerate(idx)]
        return (torch.stack([x for x, _ in outs]),
                torch.stack([it for _, it in outs]))


class EnsembleBPDecoder(_Ensemble):
    """SPA / MSA over a code ensemble, each member through
    :class:`BPDecoder` (same ``max_iter``, ``iter_cap``, ``msg_dtype``,
    ``check_init`` and ``inf_policy``; MSA forces ``saturate``)."""

    def __init__(self, graphs: Sequence[TannerGraph], variant: str = "SPA",
                 max_iter: int = 10, iter_cap: int = 1000,
                 msg_dtype=torch.float32, check_init: bool = True,
                 inf_policy: str = "reference", device=None, **_):
        members = [BPDecoder(g, variant, max_iter=max_iter,
                             iter_cap=iter_cap, msg_dtype=msg_dtype,
                             check_init=check_init, inf_policy=inf_policy,
                             device=device) for g in graphs]
        super().__init__(members, graphs)


class EnsembleBECSPADecoder(_Ensemble):
    """Ternary-message erasure SPA over a code ensemble, each member
    through :class:`BECSPADecoder`: y [G, B, V] symbols in {0, 1, 2} ->
    (x_hat [G, B, V] in {0, 1, 2}, iters [G, B])."""

    def __init__(self, graphs: Sequence[TannerGraph], max_iter: int = 10,
                 iter_cap: int = 1000, device=None, **_):
        members = [BECSPADecoder(g, max_iter=max_iter, iter_cap=iter_cap,
                                 device=device) for g in graphs]
        super().__init__(members, graphs)
