"""The plain reference of the benchmark: a straightforward PyTorch version
of what a sweep point of the Monte-Carlo runner computes, written apart
from the program and importing nothing of it (nor JAX).

- ``codes``: the parity-check file and the index tables of its graph;
- ``seeding``: the generator of point ``idx`` of a run, as the runner
  seeds it;
- ``channels``: the channel's draw and LLRs, in the runner's float32 order;
- ``minsum`` and ``admm``: the plain decoders, in the arithmetic order the
  program states (its CUDA kernels equal its plain versions bit for bit);
- ``decoders/``: one file per decoder a configuration names
  (``decoders/<decoder>.py``, found by that name): the plain decoder as a
  run config sets it, the control's precision, and whether the program
  keeps the iteration histogram;
- ``replay``: a whole point (the runner's dispatch, consume, adaptive
  pipeline and stop rule) replayed from the seed, with its tallies.
"""
