"""Launch geometry of the whole-loop decode kernels on an H100: ``threads``
per codeword, ``words`` codewords per CTA (one for the SPA and ADMM
kernels), each word's state in shared memory, plus tables a CTA's words
share.

Each kernel's wrapper keeps its own shared-memory formula and its own rule
for the geometry (``admm_kernel.admm_geometry``,
``spa_kernel.spa_geometry``, ``bec_kernel.bec_geometry``,
``msa_kernel.msa_geometry``); what a launch must satisfy, and the card's
figures the rules read, live here.
"""

from __future__ import annotations

from typing import NamedTuple

WARP = 32
MAX_THREADS = 1024      # CUDA threads per CTA
# One H100 SM: the shared memory it gives one CTA (227 KB), what it has
# for all resident CTAs (228 KB, of which the runtime keeps 1 KB per CTA),
# and its resident warps.
SMEM_PER_CTA = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
WARPS_PER_SM = 64
CTAS_PER_SM = 32


class Geometry(NamedTuple):
    """How a decode is launched: ``threads`` per word, the word's shared
    memory in bytes, ``words`` per CTA, and ``table_bytes`` of shared
    memory per CTA that its words share."""
    threads: int
    smem_bytes: int
    words: int = 1
    table_bytes: int = 0


def make_geometry(threads: int, smem_bytes: int, words: int = 1,
                  table_bytes: int = 0) -> Geometry:
    """``threads`` per word for a word of ``smem_bytes`` of shared memory,
    ``words`` per CTA beside ``table_bytes`` they share, or ValueError
    where the card cannot take it."""
    if threads % WARP or not WARP <= threads <= MAX_THREADS:
        raise ValueError(f"threads per word must be a multiple of {WARP} "
                         f"in [{WARP}, {MAX_THREADS}], got {threads}")
    if words < 1 or threads * words > MAX_THREADS:
        raise ValueError(f"{words} words per CTA of {threads} threads each: "
                         f"a CTA has 1 to {MAX_THREADS} threads")
    cta_bytes = table_bytes + words * smem_bytes
    if cta_bytes > SMEM_PER_CTA:
        raise ValueError(f"a CTA of {words} words needs {cta_bytes} bytes of "
                         f"shared memory, an SM gives a CTA {SMEM_PER_CTA}")
    return Geometry(threads, smem_bytes, words, table_bytes)


def words_per_sm(smem_bytes: int) -> int:
    """The words an SM holds by shared memory alone (one word per CTA)."""
    return SMEM_PER_SM // (smem_bytes + SMEM_RESERVED)


def resident_words(geo: Geometry) -> int:
    """The words an SM holds at ``geo``, by shared memory and by warps
    (registers aside: the launch asks the card)."""
    ctas = min(SMEM_PER_SM // (geo.table_bytes + geo.words * geo.smem_bytes
                               + SMEM_RESERVED),
               WARPS_PER_SM // (geo.words * geo.threads // WARP), CTAS_PER_SM)
    return ctas * geo.words


def row_threads(C: int, warps: int) -> int:
    """Threads for ``warps`` warps that each own a run of 32 of the C check
    rows: no more warps than the rows have runs."""
    return WARP * min(-(-C // WARP), warps)


def group_rule(make, C: int, group_warps) -> Geometry:
    """The erasure and min-sum kernels' rule, over every geometry
    ``make(warps per word, words per CTA)`` accepts with no warp short of
    check rows (one warp per run of 32 of the C rows at most): the most
    warps an SM holds, then the more warps per word (a shorter iteration),
    then the more words per CTA. Raises ``make``'s ValueError where not
    even one word of one warp fits."""
    geos = [make(1, 1)]
    for g in group_warps:
        if WARP * g > row_threads(C, g):
            continue
        for words in range(1 if g > 1 else 2, MAX_THREADS // (WARP * g) + 1):
            try:
                geos.append(make(g, words))
            except ValueError:
                pass
    return max(geos, key=lambda geo: (
        resident_words(geo) * geo.threads // WARP, geo.threads, geo.words))
