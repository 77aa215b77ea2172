"""The device's idle share of the window: 1 - (the union of its
operations' intervals) / the window's wall time. Split by the end-to-end
metric it moves: ``.cw`` (``cw_per_s``), ``.converge``
(``cw_per_s.converge``), ``.point`` (``ms_per_point``)."""


def read(ctx):
    if not ctx.ops:
        return None
    return 100.0 * (1.0 - ctx.busy() / ctx.window_s)
