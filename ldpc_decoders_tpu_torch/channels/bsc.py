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

from ldpc_decoders_tpu_torch.decoders.bp import BPDecoder


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
    """Adapts an LLR-domain decoder to channel symbols."""

    def __init__(self, dec):
        self.dec = dec
        self.id_keys = dec.id_keys

    def decode(self, y, p):
        x_hat, iters = self.dec.decode(llr(y, p))
        return x_hat, {"iters": iters}


def SPA(code, device=None, **kw):
    return _LLRWrapped(BPDecoder(code.graph, "SPA", device=device, **kw))


def MSA(code, device=None, **kw):
    return _LLRWrapped(BPDecoder(code.graph, "MSA", device=device, **kw))


DECODERS = {"SPA": SPA, "MSA": MSA}
