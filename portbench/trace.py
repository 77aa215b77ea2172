"""The traced window: a ``torch.profiler`` window with CUDA activity only
(the CPU's activity would record every PyTorch call on the host and hold
the device back), the device's operations read from its trace, and the
benchmark's own host spans around each point.

The trace's clock is tied to the host's by two marker kernels
(``torch.cuda._sleep``), launched just after a synchronize at the window's
open and close: a device time maps to the host's clock linearly through
the two, and only the operations between them are read. The profiler runs
``EDGE_S`` before the first marker and after the last: the trace's device
stamps stray from its host stamps by up to milliseconds, and a marker
stamped outside the profiler's own window is dropped.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import glob
import os
import re
import time
import warnings
from typing import Callable, List, Optional

import torch

MARKER = "spin_kernel"
EDGE_S = 0.02
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


@dataclasses.dataclass
class Op:
    name: str
    start: float      # host clock, s
    end: float


class Window:
    """Starts the profiler and the first marker (``open``), the second
    marker and the stop (``close``), then the device's operations in host
    time (``ops``)."""

    def __init__(self):
        self.prof = None
        self.marks: list = []

    def _mark(self) -> None:
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        torch.cuda._sleep(1000)

    def open(self) -> None:
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        time.sleep(EDGE_S)
        self._mark()

    def close(self) -> None:
        self._mark()
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
        self.prof.stop()

    def _device_events(self) -> list:
        """(name, start_us, duration_us) of every operation on the device,
        from the profiler's own event list."""
        cuda = torch.autograd.DeviceType.CUDA
        return [(e.name(), e.start_ns() * 1e-3, e.duration_ns() * 1e-3)
                for e in self.prof.profiler.kineto_results.events()
                if e.device_type() == cuda]

    def ops(self) -> List[Op]:
        dev = sorted(self._device_events(), key=lambda e: e[1])
        marks = [e for e in dev if MARKER in e[0]]
        if len(marks) != 2:
            raise RuntimeError(f"found {len(marks)} marker kernels in the "
                               "trace, not 2: the device's times cannot be "
                               "placed on the host's clock")
        d0, d1 = marks[0][1] * 1e-6, marks[1][1] * 1e-6
        h0, h1 = self.marks
        scale = (h1 - h0) / (d1 - d0)

        def host(us):
            return h0 + (us * 1e-6 - d0) * scale

        return [Op(name, host(ts), host(ts + dur))
                for name, ts, dur in dev if MARKER not in name
                and marks[0][1] <= ts <= marks[1][1]]


def union(intervals) -> list:
    """Merged, sorted [start, end] intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def port_kernels(root: str) -> dict:
    """{kernel name: source file} of the program's hand-written kernels
    (``ldpc_decoders_tpu_torch/csrc/*.cu``)."""
    names = {}
    for path in glob.glob(os.path.join(root, "ldpc_decoders_tpu_torch",
                                       "csrc", "*.cu")):
        with open(path) as fp:
            for name in _GLOBAL.findall(fp.read()):
                names[name] = os.path.basename(path)
    return names


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads: the device's operations
    inside the window (host clock), the window, the points with their host
    spans and results, the cell's configuration and traffic, the graph's
    sizes and the reference's counts on the words it checked. On several
    ranks it is rank 0's: its trace, its share of the batch (``batch``),
    its own words (``words``, the points' summed ``tot`` over ``ranks``)
    and the reference's counts on its words."""
    ops: List[Op]
    t_open: float
    t_close: float
    points: list
    config: dict
    traffic: dict
    batch: int
    graph: dict
    reference: dict
    kernels: dict
    ranks: int = 1

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    @property
    def words(self) -> int:
        return sum(p["tot"] for p in self.points) // self.ranks

    @property
    def chunks(self) -> int:
        return self.words // self.batch

    def source(self, op: Op) -> Optional[str]:
        """The program's source file of a hand-written kernel, or None."""
        return self._sources.get(op.name)

    @functools.cached_property
    def _sources(self) -> dict:
        out = {}
        for name in {op.name for op in self.ops}:
            out[name] = next((self.kernels[w] for w in re.findall(r"\w+", name)
                              if w in self.kernels), None)
        return out

    def device_s(self, pick: Callable[[Op], bool]) -> float:
        return sum(op.end - op.start for op in self.ops if pick(op))

    @functools.cached_property
    def merged(self) -> list:
        """The device's busy intervals inside the window, merged."""
        return union([max(op.start, self.t_open), min(op.end, self.t_close)]
                     for op in self.ops if op.end > self.t_open
                     and op.start < self.t_close)

    @functools.cached_property
    def _prefix(self) -> tuple:
        starts = [a for a, _ in self.merged]
        done = [0.0]
        for a, b in self.merged:
            done.append(done[-1] + b - a)
        return starts, done

    def busy(self, lo: Optional[float] = None,
             hi: Optional[float] = None) -> float:
        """Seconds of [lo, hi] (default: the window) the device was busy."""
        lo = self.t_open if lo is None else lo
        hi = self.t_close if hi is None else hi
        starts, done = self._prefix
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        j = bisect.bisect_left(starts, hi)
        if j <= i:
            return 0.0
        inner = done[j] - done[i]
        a, b = self.merged[i]
        inner -= max(0.0, min(b, lo) - a)
        a, b = self.merged[j - 1]
        inner -= max(0.0, b - max(a, hi))
        return max(0.0, inner)


def breakdown(ctx: Context, top: int = 10) -> dict:
    """The device operations that took the most time (by name, seconds)
    and the longest idle gaps, each named by the host span open then."""
    by_name: dict = {}
    for op in ctx.ops:
        by_name[op.name] = by_name.get(op.name, 0.0) + op.end - op.start
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = ([ctx.t_open] + [x for ab in ctx.merged for x in ab]
             + [ctx.t_close])
    gaps = sorted(([a, b] for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), key=lambda g: g[0] - g[1])[:top]
    starts = [p["start"] for p in ctx.points]
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(starts, mid) - 1
        span = ctx.points[k] if k >= 0 and mid < ctx.points[k]["end"] \
            else None
        named.append([f"run_param {span['param']}" if span
                      else "harness between points", b - a])
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": named}
