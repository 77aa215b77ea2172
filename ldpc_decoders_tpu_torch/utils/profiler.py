"""Per-section wall-clock loop profiler (counterpart of
``ldpc_decoders_tpu.utils.profiler``).

Context-manager tags accumulate elapsed milliseconds per section; every
``dump_freq`` steps the summary is logged and reset. The runner enables it
with ``RunConfig(profile=True)``: kernel launches are asynchronous, so the
tag boundaries show where the host really waits for the card.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict


class LoopProfiler:
    class Tag:
        def __init__(self, name, prof):
            self.name, self.prof = name, prof

        def elapsed(self) -> float:
            return (time.time() - self.updated) * 1000.0

        def __enter__(self):
            self.updated = time.time()
            self.prof.log.debug("(( '%s'", self.name)
            return self

        def __exit__(self, typ, value, traceback):
            ms = self.elapsed()
            self.prof.log.debug("    elapsed[%d] ))", int(ms))
            self.prof.tags[self.name] = self.prof.tags.get(self.name, 0.0) + ms

    def __init__(self, log=None, dump_freq: int = 10):
        self.log = log or logging.getLogger("profiler")
        self.dump_freq = dump_freq
        self.tags = OrderedDict()
        self.step_count = 0

    def __enter__(self):
        return self

    def start(self):
        self.step_count += 1
        return self

    def tag(self, name) -> "LoopProfiler.Tag":
        return LoopProfiler.Tag(name, self)

    def __exit__(self, typ, value, traceback):
        if self.dump_freq > 0 and self.step_count % self.dump_freq == 0:
            summary = ", ".join("'%s':%d" % (k, int(v))
                                for k, v in self.tags.items())
            self.log.info("Summary at[%d] for[%d]: [%s]",
                          self.step_count, self.dump_freq, summary)
            for key in self.tags:
                self.tags[key] = 0.0
