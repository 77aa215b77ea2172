"""Spans and counters of the program's host work, kept in memory (the
counterpart of ``ldpc_decoders_tpu.utils.profiler``, whose per-section sums
a recorder's ``summary`` gives).

A span is a named interval of ``time.perf_counter()``, the host clock that
a device trace is placed on (``portbench/trace.py`` ties the profiler's
timeline to it), so every span compares directly with the device's
operations. Spans nest: each keeps its parent and the sweep point it
belongs to (the ordinal of the enclosing ``point`` span). Counters are
named integers.

One recorder at a time is on, for the whole process: ``enable()`` switches
one on and ``disable()`` off, and ``follow_torch()``, which the runner calls
at each sweep point, keeps one on while a ``torch.profiler`` session
collects, so a traced window of the device comes with the host's spans.
While a recorder is on, each Python garbage collection is a ``gc`` span
holding its generation. With none on, a span site costs one test: no clock
read, no logging call, no allocation.

The runner's spans (``harness/runner.py``, ``harness/saver.py``): ``point``
(one ``run_param``, holding its parameter), ``dispatch`` (draw, C1, decode,
C2, the pinned copy's enqueue), ``wait`` (a chunk's event and host sum),
``log`` (``status`` and the log line), ``saver`` (``Saver.add``) and in
it ``saver.write`` (the file's open, write, close and rename); its
counters: ``chunks_dispatched`` and ``chunks_consumed`` of each point, and
``saver_reloads`` (each ``Saver.add`` that reads the file).
"""

from __future__ import annotations

import contextlib
import gc
from time import perf_counter
from typing import NamedTuple, Optional

from torch.autograd import profiler as torch_profiler


class Span(NamedTuple):
    id: int
    name: str
    start: float        # time.perf_counter(), s
    end: float
    parent: int         # the enclosing span's id, -1 at the top
    point: int          # the enclosing ``point`` span's ordinal, -1 outside
    arg: object = None  # the point's parameter, the collection's generation


class Recorder:
    """Finished spans (``spans``, in the order they end) and counters. A
    span is kept as a plain tuple in ``Span``'s order (``Span._make`` names
    its fields): the collector stops tracking such tuples, so a long
    recording adds nothing to the collections it records."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.follows_torch = False
        self._open: list = []   # [id, name, start, parent, point, arg]
        self._ids = 0
        self._points = 0

    def open(self, name: str, arg=None) -> None:
        # Ids are taken before anything is allocated: an allocation may
        # run a collection, whose ``gc`` span opens and closes in between.
        i = self._ids
        self._ids = i + 1
        top = self._open[-1] if self._open else None
        if name == "point":
            point = self._points
            self._points = point + 1
        else:
            point = top[4] if top else -1
        rec = [i, name, 0.0, top[0] if top else -1, point, arg]
        self._open.append(rec)
        rec[2] = perf_counter()

    def close(self) -> None:
        end = perf_counter()
        i, name, start, parent, point, arg = self._open.pop()
        self.spans.append((i, name, start, end, parent, point, arg))

    def summary(self) -> str:
        """``'name':ms`` of each span name over the spans that ended since
        the last summary, then ``'name':n`` of the counters counted since;
        both start again from nothing."""
        ms: dict = {}
        for _, name, start, end, *_ in self.spans:
            ms[name] = ms.get(name, 0.0) + 1e3 * (end - start)
        out = ", ".join([f"'{k}':{int(v)}" for k, v in ms.items()]
                        + [f"'{k}':{v}" for k, v in self.counters.items()])
        self.spans, self.counters = [], {}
        return out

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.open("gc", info["generation"])
        else:
            self.close()


class _Span:
    __slots__ = ("rec", "name", "arg")

    def __init__(self, rec: Recorder, name: str, arg):
        self.rec, self.name, self.arg = rec, name, arg

    def __enter__(self):
        self.rec.open(self.name, self.arg)

    def __exit__(self, typ, value, traceback):
        self.rec.close()


_OFF = contextlib.nullcontext()
_on: Optional[Recorder] = None
_last: Optional[Recorder] = None


def enable() -> Recorder:
    """Switch a new recorder on; one that is on already is an error."""
    global _on, _last
    if _on is not None:
        raise RuntimeError("a recorder is on already")
    _on = _last = Recorder()
    gc.callbacks.append(_on._gc)
    return _on


def disable() -> Optional[Recorder]:
    """Switch the recorder off (its ``gc`` hook goes) and return it."""
    global _on
    rec, _on = _on, None
    if rec is not None:
        gc.callbacks.remove(rec._gc)
    return rec


def active() -> Optional[Recorder]:
    """The recorder that is on, or None."""
    return _on


def last() -> Optional[Recorder]:
    """The recorder switched on last, on or off: where a reader finds the
    spans of a window that has closed."""
    return _last


def follow_torch() -> None:
    """Switch a recorder on while a ``torch.profiler`` session collects and
    off once none does; a recorder that ``enable()`` switched on is left
    as it is."""
    collecting = getattr(torch_profiler, "_is_profiler_enabled", False)
    if collecting and _on is None:
        enable().follows_torch = True
    elif not collecting and _on is not None and _on.follows_torch:
        disable()


def span(name: str, arg=None):
    """A span of the recorder that is on, as a context manager; with none
    on, a shared no-op."""
    if _on is None:
        return _OFF
    return _Span(_on, name, arg)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a counter of the recorder that is on, if one is."""
    if _on is not None:
        _on.counters[name] = _on.counters.get(name, 0) + n
