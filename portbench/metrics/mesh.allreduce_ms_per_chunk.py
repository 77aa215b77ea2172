"""Rank 0's collectives (NCCL's kernels: on a batch mesh over NCCL the
chunk tally's all-reduce, ``Mesh.device_tally``) in device ms per chunk
that rank 0 consumed. A collective's kernel runs from its launch until
every rank has joined, so a rank that waits for a late peer reads its wait
here."""


def read(ctx):
    if not ctx.ops or not ctx.chunks:
        return None
    t = ctx.device_s(lambda op: "nccl" in op.name.lower())
    if t <= 0:
        return None
    return 1e3 * t / ctx.chunks
