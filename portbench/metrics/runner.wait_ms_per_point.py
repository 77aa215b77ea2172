"""The host's wait on a point's chunks (``harness/runner.py``: ``consume``'s
event and host sum) per window point: the program's ``wait`` spans inside
the window, the device's time that the host does not hide."""

from portbench import spans


def read(ctx):
    return spans.ms_per_point(ctx, "wait")
