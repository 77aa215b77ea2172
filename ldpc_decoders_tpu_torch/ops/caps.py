"""Iteration-cap snapshot lists shared by the BP kernels' wrappers.

Every whole-loop kernel writes its decisions as snapshot planes
``x_hats [K, B, V]``: plane k holds the decisions after ``caps[k]``
iterations, or the final ones where the word finished earlier. A
single-cap decode is the K = 1 list ``(max_iter,)``. The kernels take the
list by value (``kMaxCaps`` ints in a kernel argument)."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

MAX_CAPS = 16           # kMaxCaps of csrc/*.cu


def check_caps(caps: Optional[Sequence[int]], max_iter: int) -> tuple:
    """The snapshot list of one decode: ``(max_iter,)`` for a single-cap
    decode, else ``caps`` checked (ascending distinct positive ints that
    end at ``max_iter``)."""
    if caps is None:
        return (int(max_iter),)
    caps = tuple(int(c) for c in caps)
    if (not caps or caps[0] < 1 or list(caps) != sorted(set(caps))
            or caps[-1] != int(max_iter)):
        raise ValueError(f"caps must be ascending distinct positive ints "
                         f"ending at max_iter={max_iter}, not {caps}")
    return caps


def caps_array(caps: tuple):
    """``caps`` as the C int array the launch functions read."""
    if len(caps) > MAX_CAPS:
        raise ValueError(f"{len(caps)} caps > {MAX_CAPS} (the kernels' "
                         "by-value cap list)")
    return (ctypes.c_int * len(caps))(*caps)


def fill_planes(x_hats: list, final: torch.Tensor, caps) -> torch.Tensor:
    """Stack a plain version's snapshot planes; a plane its loop never
    reached (``None``) holds the final decisions. A single-cap decode
    (``caps`` None) returns its one plane as [B, V]."""
    planes = torch.stack([final if x is None else x for x in x_hats])
    return planes if caps is not None else planes[0]
