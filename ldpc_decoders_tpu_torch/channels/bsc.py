"""Binary symmetric channel and its decoder family (counterpart of
``ldpc_decoders_tpu.channels.bsc``).

The channel flips each bit independently with probability p; the LLR is
log((1-p)/p) * (1-2y), computed in float32 in the JAX package's order. BP
on the BSC runs in f32 unless the caller asks for bf16: its LLRs are equal
multiples of one value, and that tie structure is not bf16-safe.
"""

from __future__ import annotations

from typing import Optional

import torch

from ldpc_decoders_tpu_torch.decoders.admm import ADMMDecoder
from ldpc_decoders_tpu_torch.decoders.admma import ADMMADecoder
from ldpc_decoders_tpu_torch.decoders.bp import BPDecoder
from ldpc_decoders_tpu_torch.decoders.lp import LPDecoder
from ldpc_decoders_tpu_torch.decoders.ml import MLBSC


def send(x: torch.Tensor, p,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flip each bit where a float32 uniform from ``generator`` (which must
    live on x's device) is < p. x [B, n] in {0,1} -> y [B, n] in {0,1}."""
    u = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                   device=x.device)
    return (x + (u < p).to(x.dtype)) % 2


def llr(y: torch.Tensor, p) -> torch.Tensor:
    pt = torch.full((), p, dtype=torch.float32, device=y.device)
    base = torch.log1p(-pt) - torch.log(pt)
    return base * (1.0 - 2.0 * y.to(torch.float32))


class _LLRWrapped:
    """Adapts an LLR-domain decoder to channel symbols. ``llr_fn`` is the
    channel's LLR map (this module's unless a channel passes its own)."""

    def __init__(self, dec, llr_fn=None):
        self.dec = dec
        self.id_keys = dec.id_keys
        self.llr = llr_fn or llr

    def decode(self, y, p, generator=None):
        x_hat, iters = self.dec.decode(self.llr(y, p))
        return x_hat, {"iters": iters}


class _HostLLRWrapped(_LLRWrapped):
    """Adapts a host-side LLR decoder (LP: numpy and scipy, in the JAX
    package too; it says so with ``host_only``): LLRs on y's device, the
    decode on the host."""

    def decode(self, y, p, generator=None):
        gamma = self.llr(y, p).cpu().numpy()
        return self.dec.decode_batch(gamma), {}


class _MLWrapped:
    """Adapts a codebook ML decoder (``cls``) to the channel's call shape."""

    id_keys: list = []

    def __init__(self, cls, code, device=None):
        self.dec = cls(code, device=device)

    def decode(self, y, p, generator=None):
        return self.dec.decode(y, p, generator), {}


def SPA(code, device=None, **kw):
    return _LLRWrapped(BPDecoder(code.graph, "SPA", device=device, **kw))


def MSA(code, device=None, **kw):
    return _LLRWrapped(BPDecoder(code.graph, "MSA", device=device, **kw))


def ML(code, device=None, **kw):
    return _MLWrapped(MLBSC, code, device=device)


def LP(code, device=None, **kw):
    return _HostLLRWrapped(LPDecoder(code.graph, **kw))


def ADMM(code, device=None, **kw):
    return _LLRWrapped(ADMMDecoder(code.graph, device=device, **kw))


def ADMMA(code, device=None, **kw):
    return _LLRWrapped(ADMMADecoder(code.graph, device=device, **kw))


DECODERS = {"ML": ML, "SPA": SPA, "MSA": MSA, "LP": LP, "ADMM": ADMM,
            "ADMMA": ADMMA}
