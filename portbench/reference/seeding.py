"""The generator of sweep point ``idx`` of a run seeded ``seed``: a
``torch.Generator`` on the device, seeded with the first 64-bit word of
numpy's ``SeedSequence([seed, idx])`` (``[seed, idx, rank, ranks]`` for
rank ``rank`` of ``ranks > 1`` along the batch)."""

from __future__ import annotations

import numpy as np
import torch


def point_seed(seed: int, idx: int, rank: int = 0, ranks: int = 1) -> int:
    key = [seed, idx] if ranks == 1 else [seed, idx, rank, ranks]
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])


def point_generator(device, seed: int, idx: int, rank: int = 0,
                    ranks: int = 1) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(point_seed(seed, idx, rank, ranks))
    return gen
