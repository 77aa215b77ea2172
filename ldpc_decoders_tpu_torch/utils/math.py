"""Small host-side math helpers (counterpart of ``ldpc_decoders_tpu.utils.math``)."""

from __future__ import annotations

import numpy as np


def binary_vectors(length: int) -> np.ndarray:
    """All 2^length binary vectors, row i = big-endian bits of i.

    Row index counts up with the FIRST column as the most significant bit,
    and row 0 is all zeros (the reference's itertools.product order).
    """
    idx = np.arange(2 ** length, dtype=np.int64)
    shifts = np.arange(length - 1, -1, -1, dtype=np.int64)
    return ((idx[:, None] >> shifts) & 1).astype(np.int64)
