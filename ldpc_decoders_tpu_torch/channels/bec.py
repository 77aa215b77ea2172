"""Binary erasure channel and its decoder family (counterpart of
``ldpc_decoders_tpu.channels.bec``).

The channel erases each symbol independently with probability p; an
erasure is symbol 2. SPA and MSA are both the ternary-message erasure SPA
(the reference aliases them on this channel), which decodes the symbols
themselves, not an LLR. ``llr`` is the "safe infinity" table (+-1e8 for
known symbols, 0 for erasures) that the LLR-domain decoders of this
channel (LP, ADMM, ADMMA) take; ML picks uniformly among the codewords
compatible with the non-erased positions.
"""

from __future__ import annotations

from typing import Optional

import torch

from ldpc_decoders_tpu_torch.channels.bsc import (
    _HostLLRWrapped,
    _LLRWrapped,
    _MLWrapped,
)
from ldpc_decoders_tpu_torch.decoders.admm import ADMMDecoder
from ldpc_decoders_tpu_torch.decoders.admma import ADMMADecoder
from ldpc_decoders_tpu_torch.decoders.bec_spa import ERASURE, BECSPADecoder
from ldpc_decoders_tpu_torch.decoders.lp import LPDecoder
from ldpc_decoders_tpu_torch.decoders.ml import MLBEC

SAFE_INF = 1e8


def send(x: torch.Tensor, p,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Erase each symbol where a float32 uniform from ``generator`` (which
    must live on x's device) is < p. x [B, n] in {0,1} -> y [B, n] int32
    in {0,1,2}."""
    u = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                   device=x.device)
    return torch.where(u < p, ERASURE, x.to(torch.int32))


def llr(y: torch.Tensor, p=None) -> torch.Tensor:
    table = torch.tensor([SAFE_INF, -SAFE_INF, 0.0], dtype=torch.float32,
                         device=y.device)
    return table[y.long()]


class _TernarySPA:
    """Adapts the symbol-domain decoder to the channel's call shape."""

    def __init__(self, code, device=None, **kw):
        self.dec = BECSPADecoder(code.graph, device=device, **kw)
        self.id_keys = self.dec.id_keys

    def decode(self, y, p, generator=None):
        x_hat, iters = self.dec.decode(y)
        return x_hat, {"iters": iters}


SPA = _TernarySPA
MSA = _TernarySPA   # the reference aliases MSA = SPA on the BEC


def ML(code, device=None, **kw):
    return _MLWrapped(MLBEC, code, device=device)


def LP(code, device=None, **kw):
    return _HostLLRWrapped(LPDecoder(code.graph, **kw), llr)


def ADMM(code, device=None, **kw):
    return _LLRWrapped(ADMMDecoder(code.graph, device=device, **kw), llr)


def ADMMA(code, device=None, **kw):
    return _LLRWrapped(ADMMADecoder(code.graph, device=device, **kw), llr)


DECODERS = {"ML": ML, "SPA": SPA, "MSA": MSA, "LP": LP, "ADMM": ADMM,
            "ADMMA": ADMMA}
