"""Batched exhaustive-codebook maximum-likelihood decoders (counterpart of
``ldpc_decoders_tpu.decoders.ml``): the exactness oracle for short codes.

Scoring the codebook is one matrix product per batch ([B, n] x [n, 2^k]),
left to ``torch.matmul`` as the JAX package leaves it to XLA (it is outside
any kernel there):

- BSC: the log-likelihood is affine in the agreement count, which is
  affine in (2y-1) . (2c-1);
- biAWGN: -||(2c-1) - y||^2 is affine in y . (2c-1) because ||2c-1||^2 = n.
  The product must be full float32 (TF32 would round the real-valued y and
  make the oracle non-ML on near-tie words): this module never switches
  TF32 on, and PyTorch's default for matmul is off;
- BEC: a codeword is feasible iff it matches every non-erased symbol; all
  feasible codewords are equally likely, so ML is a uniform choice among
  them.

Ties are broken uniformly at random from an explicit ``torch.Generator``:
uniform keys masked to the argmax set.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def arg_max_rand_batched(values: torch.Tensor,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """[B, K] -> [B]: argmax index, ties broken uniformly at random."""
    is_max = values >= values.amax(dim=-1, keepdim=True)
    return _rand_pick(is_max, generator)


def _rand_pick(allowed: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    r = torch.rand(allowed.shape, generator=generator, dtype=torch.float32,
                   device=allowed.device)
    return torch.argmax(torch.where(allowed, r, -1.0), dim=-1)


class MLDecoderBase:
    id_keys: list = []

    def __init__(self, code, device=None, **_):
        if code.cb is None:
            raise ValueError("ML decoding needs the enumerated codebook "
                             "(generator matrix required)")
        self.cb = torch.as_tensor(code.cb, dtype=torch.float32,
                                  device=device)                  # [K, n]
        self.cb_pm = 2.0 * self.cb - 1.0                          # [K, n]
        self.n = code.get_n()

    def _rows(self, idx: torch.Tensor) -> torch.Tensor:
        return self.cb[idx].to(torch.int32)


class MLBSC(MLDecoderBase):
    """ML for the binary symmetric channel."""

    def decode(self, y: torch.Tensor, p,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y_pm = 2.0 * y.to(torch.float32) - 1.0                    # [B, n]
        # agrees = (n + y_pm . cb_pm) / 2; log_prob is affine in agrees.
        agree2 = y_pm @ self.cb_pm.T                              # [B, K]
        log_p, log_1p = math.log(p), math.log1p(-p)
        log_prob = (self.n - (self.n + agree2) / 2) * log_p \
            + ((self.n + agree2) / 2) * log_1p
        return self._rows(arg_max_rand_batched(log_prob, generator))


class MLBiAWGN(MLDecoderBase):
    """ML for the biAWGN channel."""

    def decode(self, y: torch.Tensor, snr_db,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # argmax of -||cb_pm - y||^2 = argmax of y . cb_pm (||cb_pm||^2 = n).
        score = y.to(torch.float32) @ self.cb_pm.T                # [B, K]
        return self._rows(arg_max_rand_batched(score, generator))


class MLBEC(MLDecoderBase):
    """ML for the erasure channel: a uniform choice among the codewords
    that agree with every non-erased position."""

    def decode(self, y: torch.Tensor, p,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # Disagreements on non-erased positions: a codeword bit 1 against
        # an observed 0 and the other way round (erasures match neither).
        y0 = (y == 0).to(torch.float32)
        y1 = (y == 1).to(torch.float32)
        diffs = y0 @ self.cb.T + y1 @ (1.0 - self.cb).T           # [B, K]
        return self._rows(_rand_pick(diffs == 0, generator))
