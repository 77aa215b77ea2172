"""Small host-side math helpers (counterpart of ``ldpc_decoders_tpu.utils.math``)."""

from __future__ import annotations

import numpy as np
import torch


def binary_vectors(length: int) -> np.ndarray:
    """All 2^length binary vectors, row i = big-endian bits of i.

    Row index counts up with the FIRST column as the most significant bit,
    and row 0 is all zeros (the reference's itertools.product order).
    """
    idx = np.arange(2 ** length, dtype=np.int64)
    shifts = np.arange(length - 1, -1, -1, dtype=np.int64)
    return ((idx[:, None] >> shifts) & 1).astype(np.int64)


def pseudo_to_cw(x: np.ndarray, allow_pseudo: bool, eps: float = 1e-8) -> np.ndarray:
    """Snap a fractional LP/ADMM solution to {0,1} only where it is within
    eps of integral (allow_pseudo=True keeps interior pseudo-codeword
    coordinates fractional); otherwise threshold at 0.5.
    """
    x = np.array(x, dtype=np.float64)
    if allow_pseudo:
        x[x < eps] = 0.0
        x[1.0 - x < eps] = 1.0
        return x
    return (x > 0.5).astype(np.int64)


def pseudo_to_cw_tensor(x: torch.Tensor, allow_pseudo: bool,
                        eps: float = 1e-8) -> torch.Tensor:
    """Tensor twin of :func:`pseudo_to_cw` (the ADMM decoder's output
    stage): int32 decisions, or with ``allow_pseudo`` the float values
    snapped only within eps of 0 or 1."""
    if not allow_pseudo:
        return (x > 0.5).to(torch.int32)
    x = torch.where(x < eps, 0.0, x)
    return torch.where(1.0 - x < eps, 1.0, x)
