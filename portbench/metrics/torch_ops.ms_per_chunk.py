"""Device time per chunk of every operation that is neither a hand-written
kernel of the program (``csrc/``) nor a collective: the channel's draw
(``channels/*.py:draw``), copies, fills and any other PyTorch launch around
the kernels. Split by the end-to-end metric it moves: the name alone moves
``cw_per_s``, ``.converge`` moves ``cw_per_s.converge``."""


def read(ctx):
    if not ctx.ops or not ctx.chunks:
        return None
    t = ctx.device_s(lambda op: ctx.source(op) is None
                     and "nccl" not in op.name.lower())
    return 1e3 * t / ctx.chunks
