"""Binary-input AWGN channel and its decoder family (counterpart of
``ldpc_decoders_tpu.channels.biawgn``).

BPSK maps bits {0,1} to {-1,+1}; the channel parameter is the SNR in dB
with noise_var = 10^(-snr/10); LLR = -2y/noise_var. Arithmetic is float32
in the JAX package's order, so the same noise gives the same bits.
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
from ldpc_decoders_tpu_torch.decoders.bp import BPDecoder
from ldpc_decoders_tpu_torch.decoders.lp import LPDecoder
from ldpc_decoders_tpu_torch.decoders.ml import MLBiAWGN


def noise_var(snr_db):
    return 10.0 ** (-snr_db / 10.0)


def _f32(val, like: torch.Tensor) -> torch.Tensor:
    # A 0-dim tensor on the data's device, not a Python scalar: the
    # operation then rounds exactly like JAX's weakly typed float32
    # constant (CUDA divides by a host scalar as a multiply by its
    # reciprocal, which rounds differently). ``full`` fills on the device,
    # without a host-to-device copy.
    return torch.full((), val, dtype=torch.float32, device=like.device)


def send(x: torch.Tensor, snr_db,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x [B, n] in {0,1} -> y [B, n] float32, noise from ``generator``
    (which must live on x's device)."""
    noise = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                        device=x.device)
    std = torch.sqrt(_f32(noise_var(snr_db), x))
    return (2.0 * x.to(torch.float32) - 1.0) + std * noise


def llr(y: torch.Tensor, snr_db) -> torch.Tensor:
    return -2.0 * y / _f32(noise_var(snr_db), y)


# check_init=False: the reference initializes x_hat to the real-valued y,
# which never satisfies the syndrome, so biAWGN BP always runs at least
# one iteration.
def SPA(code, device=None, **kw):
    return _LLRWrapped(BPDecoder(code.graph, "SPA", check_init=False,
                                 device=device, **kw), llr)


def MSA(code, device=None, **kw):
    return _LLRWrapped(BPDecoder(code.graph, "MSA", check_init=False,
                                 device=device, **kw), llr)


def ML(code, device=None, **kw):
    return _MLWrapped(MLBiAWGN, code, device=device)


def LP(code, device=None, **kw):
    return _HostLLRWrapped(LPDecoder(code.graph, **kw), llr)


def ADMM(code, device=None, **kw):
    return _LLRWrapped(ADMMDecoder(code.graph, device=device, **kw), llr)


def ADMMA(code, device=None, **kw):
    return _LLRWrapped(ADMMADecoder(code.graph, device=device, **kw), llr)


DECODERS = {"ML": ML, "SPA": SPA, "MSA": MSA, "LP": LP, "ADMM": ADMM,
            "ADMMA": ADMMA}
