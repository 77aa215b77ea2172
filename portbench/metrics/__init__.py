"""One reader per per-layer metric, ``<metric name>.py``, found by the
name in ``BENCHMARK.json``; a quantity split by the end-to-end metric it
moves (``<quantity>.<split>``) has one reader, ``<quantity>.py``. ``read(ctx)`` takes a ``trace.Context`` and
returns the metric's value, or None where the window holds nothing for it
to read (the harness then leaves the metric out of the line)."""
