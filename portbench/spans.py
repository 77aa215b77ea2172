"""The program's own spans in a traced window: what the runner, the Saver
and the garbage collector did on the host (``ldpc_decoders_tpu_torch/
utils/profiler.py``, on the host clock the device trace is placed on).

The program records them while a ``torch.profiler`` session collects, as
it does in a traced run's window. A program without that recorder leaves
nothing to read here: each function returns None, and the readers that
use them leave their metric out of the line.

    python3 -m portbench.spans --workload <name> --seed <n> --seconds <s>

runs one traced cell as ``portbench.run --trace 1`` does and prints its
line with each of the longest idle gaps named by the innermost program
span open at its midpoint (``breakdown``).
"""

from __future__ import annotations

import sys
from typing import Optional

BETWEEN = "harness between points"


def program_spans(ctx) -> Optional[list]:
    """The spans the program recorded that overlap the window, or None
    where there are none (no points, no recorder, nothing recorded)."""
    if not ctx.points:
        return None
    from ldpc_decoders_tpu_torch.utils import profiler

    last = getattr(profiler, "last", None)
    rec = last() if callable(last) else None
    if rec is None:
        return None
    spans = [s for s in map(profiler.Span._make, rec.spans)
             if s.end > ctx.t_open and s.start < ctx.t_close]
    return spans or None


def ms_per_point(ctx, name: str, self_time: bool = False) -> Optional[float]:
    """Milliseconds per window point of the ``name`` spans inside the
    window; with ``self_time``, less the time of their child spans."""
    spans = program_spans(ctx)
    if spans is None:
        return None

    def inside(s):
        return max(0.0, min(s.end, ctx.t_close) - max(s.start, ctx.t_open))

    total = sum(inside(s) for s in spans if s.name == name)
    if self_time:
        ids = {s.id for s in spans if s.name == name}
        total -= sum(inside(s) for s in spans if s.parent in ids)
    return 1e3 * total / len(ctx.points)


def name_at(spans: list, t: float) -> str:
    """The innermost program span open at ``t`` (the latest to start of
    those that hold it, as spans nest), else the harness's own time."""
    best = None
    for s in spans:
        if s.start <= t < s.end and (best is None or s.start > best.start):
            best = s
    return best.name if best else BETWEEN


def breakdown(ctx, top: int = 10, plain=None) -> dict:
    """``trace.breakdown`` (or ``plain``), with each of the longest idle
    gaps named by the program span open at its midpoint; without program
    spans, exactly ``trace.breakdown``."""
    from portbench import trace

    out = (plain or trace.breakdown)(ctx, top)
    spans = program_spans(ctx)
    if spans is None:
        return out
    edges = ([ctx.t_open] + [x for ab in ctx.merged for x in ab]
             + [ctx.t_close])
    gaps = sorted(([a, b] for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), key=lambda g: g[0] - g[1])[:top]
    out["idle_gaps"] = [[name_at(spans, 0.5 * (a + b)), b - a]
                        for a, b in gaps]
    return out


def main(argv=None) -> int:
    from portbench import run  # first: its clock starts the set-up
    from portbench import trace

    argv = list(sys.argv[1:] if argv is None else argv)
    plain = trace.breakdown
    trace.breakdown = lambda ctx, top=10: breakdown(ctx, top, plain)
    return run.main(argv + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
