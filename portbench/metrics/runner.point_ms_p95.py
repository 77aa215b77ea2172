"""The 95th percentile (nearest rank) of the window's sweep points' wall
times, by the host's clock around each ``run_param``. Each point of the
documented sweep is one chunk, so the Monte-Carlo statistics do not enter:
a host stall (Saver I/O, logging, a lazy re-initialisation) shows here
first."""

import math


def read(ctx):
    if not ctx.points:
        return None
    walls = sorted(p["end"] - p["start"] for p in ctx.points)
    return 1e3 * walls[max(0, math.ceil(0.95 * len(walls)) - 1)]
