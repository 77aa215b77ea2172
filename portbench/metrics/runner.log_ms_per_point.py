"""The runner's ``status`` and log line (``harness/runner.py``:
``log_status``) per window point: the program's ``log`` spans inside the
window, less the spans inside them (the Saver's write, a collection)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_point(ctx, "log", self_time=True)
