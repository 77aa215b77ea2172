"""Python's garbage collections per window point: the program's ``gc``
spans (one per collection, while its recorder is on) inside the window."""

from portbench import spans


def read(ctx):
    return spans.ms_per_point(ctx, "gc")
