"""The chunk kernels (``ops/chunk_kernel.py`` -> ``csrc/chunk.cu``: C1
``transmit``, C2 ``tally``) against their summed bytes bound: C1 reads the
float32 draw and writes the decoder's float32 input, C2 reads the int32
decisions (and iteration counts where the histogram is kept) and writes a
tally per chunk. The bound is HBM's: where a chunk's draw fits in the
card's 50 MB L2 (2048 x 2640 float32 is 21.6 MB), C1 reads it from L2 just
after ``torch.rand`` wrote it, and the share can pass 100%. So the metric
is reported only in cells whose chunks are larger (16384 x 1200, 78.6 MB)."""

from portbench import roofline, spec


def read(ctx):
    t = ctx.device_s(lambda op: ctx.source(op) == "chunk.cu")
    if t <= 0:
        return None
    n = ctx.graph["n_var"]
    hist = spec.reference_decoder(
        ctx.config["run_config"]["decoder"]).TRACK_ITER_HIST
    n_bytes = (roofline.transmit(ctx.words, n)
               + roofline.tally(ctx.words, ctx.chunks, n, hist))
    return 100.0 * roofline.bound_s(n_bytes, 0) / t
