"""The channel's draw and the decoder's input (LLRs), in float32 and in the
order the program states for them: every product, sum and quotient a
PyTorch operation of its own, constants as 0-dim float32 tensors on the
device (a quotient by such a tensor is a true division).

- biAWGN, parameter the SNR in dB: var = 10^(-snr/10), y = (2x - 1) +
  sqrt(var) * n with n standard normal, LLR = -2y / var;
- BSC, parameter the crossover p: y = x xor (u < p) with u uniform on
  [0, 1), LLR = (log1p(-p) - log(p)) * (1 - 2y).
"""

from __future__ import annotations

import torch

F32 = torch.float32


def _scalar(val, device) -> torch.Tensor:
    return torch.full((), val, dtype=F32, device=device)


def draw(channel: str, shape, gen: torch.Generator, device) -> torch.Tensor:
    if channel == "biawgn":
        return torch.randn(shape, generator=gen, dtype=F32, device=device)
    if channel == "bsc":
        return torch.rand(shape, generator=gen, dtype=F32, device=device)
    raise ValueError(f"the reference has no channel {channel!r}")


def llr(channel: str, codeword: int, noise: torch.Tensor,
        param: float) -> torch.Tensor:
    """The LLRs [B, V] of the all-``codeword`` words sent over the channel
    with the draw ``noise``."""
    dev = noise.device
    x = torch.full(noise.shape, codeword, dtype=torch.int32, device=dev)
    if channel == "biawgn":
        var = _scalar(10.0 ** (-param / 10.0), dev)
        y = (2.0 * x.to(F32) - 1.0) + torch.sqrt(var) * noise
        return -2.0 * y / var
    if channel == "bsc":
        y = (x + (noise < param).to(x.dtype)) % 2
        p = _scalar(param, dev)
        base = torch.log1p(-p) - torch.log(p)
        return base * (1.0 - 2.0 * y.to(F32))
    raise ValueError(f"the reference has no channel {channel!r}")
