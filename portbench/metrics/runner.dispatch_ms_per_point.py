"""The host's dispatch of a point's chunks (``harness/runner.py:_dispatch``:
the draw, C1, the decode, C2 and the pinned copy's enqueue, as the host
issues them) per window point: the program's ``dispatch`` spans inside the
window."""

from portbench import spans


def read(ctx):
    return spans.ms_per_point(ctx, "dispatch")
