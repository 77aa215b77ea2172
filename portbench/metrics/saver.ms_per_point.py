"""The Saver's load, merge, dump and rename of its JSON file
(``harness/saver.py:Saver.add``), per window point: the program's ``saver``
spans inside the window."""

from portbench import spans


def read(ctx):
    return spans.ms_per_point(ctx, "saver")
