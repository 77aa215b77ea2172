"""Work counts and the card's published peaks, for the roofline shares.

A share is the least time the card could take for the work, the larger of
its bytes over the memory bandwidth and its operations over the float32
rate, divided by the kernel's measured device time. Work is counted from
the cell's shapes and the iterations its words needed, never from a
kernel's launch geometry or its time, so the share reads the same work
whatever implements the layer.
"""

# NVIDIA H100 SXM, dense rates at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Arithmetic operations of min-sum per edge and iteration (check pass and
# variable pass).
MSA_OPS_PER_EDGE_ITER = 12


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def msa_decode(words: int, iterations: float, n_var: int,
               n_edge: int) -> tuple:
    """(bytes, operations) of min-sum decodes of ``words`` words that ran
    ``iterations`` iterations in all: the LLRs (float32) in, the decisions
    (int32) and an iteration count per word out, each once."""
    return (words * (4 * n_var * 2 + 4),
            iterations * n_edge * MSA_OPS_PER_EDGE_ITER)


def admm_update_ops(updates: float, n_edge: int, n_var: int,
                    dc: int) -> float:
    """Operations of ``updates`` word updates of ADMM, per edge whatever
    the row: x-update 3 and 5 per variable, v 2, rank 3 per other slot,
    clip and its sum 3, f 1, f.z 2, the choice of z_new 1, both norms 6,
    the dual update 2, and 4 per row. The bracket search that rows outside
    the polytope need is not counted, so this is a floor."""
    return updates * n_edge * (20 + 3 * (dc - 1) + 5 * n_var / n_edge
                               + 4 / dc)


def admm_decode(words: int, updates: float, n_var: int, n_edge: int,
                dc: int) -> tuple:
    """(bytes, operations) of ADMM decodes: the LLRs in, the decisions and
    the fractional solution (4 bytes each) and an iteration count out."""
    return (words * (4 * n_var * 3 + 4),
            admm_update_ops(updates, n_edge, n_var, dc))


def transmit(words: int, n_var: int, planes_out: int = 1) -> int:
    """Bytes of C1: the float32 draw in, ``planes_out`` 4-byte planes out
    (LLRs, or symbols and LLRs)."""
    return words * 4 * n_var * (1 + planes_out)


def tally(words: int, calls: int, n_var: int, hist: bool,
          hist_len: int = 2000) -> int:
    """Bytes of C2 on one plane over ``calls`` chunks: the int32 decisions
    in (and the int32 iteration counts with the histogram), each chunk's
    int64 tally out."""
    return (words * (4 * n_var + (4 if hist else 0))
            + calls * 8 * (2 + (hist_len if hist else 0)))
