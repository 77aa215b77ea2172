"""Host-side helpers: math, file I/O, loop profiling."""
