"""The host's part of a sweep point (``harness/runner.py``: dispatch, the
consume wait, the stop rule and the log; ``harness/saver.py``'s write): a
point's wall time less the device's busy time inside it, averaged over the
window's points."""


def read(ctx):
    if not ctx.ops or not ctx.points:
        return None
    host = [(p["end"] - p["start"]) - ctx.busy(p["start"], p["end"])
            for p in ctx.points]
    return 1e3 * sum(host) / len(host)
