"""Rank 0's host dispatch of a chunk on a batch mesh (``harness/runner.py:
_dispatch``: the draw, C1, the decode, C2, the tally's all-reduce and the
pinned copy's enqueue, as the host issues them): the program's
``dispatch`` spans inside the window, in ms per chunk rank 0 consumed."""

from portbench import spans


def read(ctx):
    total = spans.span_ms(ctx, "dispatch")
    if total is None or not ctx.chunks:
        return None
    return total / ctx.chunks
