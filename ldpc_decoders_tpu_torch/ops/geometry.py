"""Launch geometry of the whole-loop decode kernels on an H100: one CTA per
codeword, ``threads`` per word, the word's state in shared memory.

Each kernel's wrapper keeps its own shared-memory formula and its own rule
for the thread count (``admm_kernel.admm_geometry``,
``spa_kernel.spa_geometry``); what a launch must satisfy, and the card's
figures the rules read, live here.
"""

from __future__ import annotations

from typing import NamedTuple

WARP = 32
MAX_THREADS = 1024      # CUDA threads per codeword (one CTA per word)
# One H100 SM: the shared memory it gives one CTA (227 KB), what it has
# for all resident CTAs (228 KB, of which the runtime keeps 1 KB per CTA),
# and its resident warps.
SMEM_PER_CTA = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
WARPS_PER_SM = 64


class Geometry(NamedTuple):
    """How a decode is launched: ``threads`` per word (one CTA) and the
    word's shared memory in bytes."""
    threads: int
    smem_bytes: int


def make_geometry(threads: int, smem_bytes: int) -> Geometry:
    """``threads`` per word for a word of ``smem_bytes`` of shared memory,
    or ValueError where the card cannot take it."""
    if threads % WARP or not WARP <= threads <= MAX_THREADS:
        raise ValueError(f"threads per word must be a multiple of {WARP} "
                         f"in [{WARP}, {MAX_THREADS}], got {threads}")
    if smem_bytes > SMEM_PER_CTA:
        raise ValueError(f"a word needs {smem_bytes} bytes of shared memory, "
                         f"an SM gives a CTA {SMEM_PER_CTA}")
    return Geometry(threads, smem_bytes)


def words_per_sm(smem_bytes: int) -> int:
    """The words an SM holds by shared memory alone."""
    return SMEM_PER_SM // (smem_bytes + SMEM_RESERVED)


def row_threads(C: int, warps: int) -> int:
    """Threads for ``warps`` warps that each own a run of 32 of the C check
    rows: no more warps than the rows have runs."""
    return WARP * min(-(-C // WARP), warps)
