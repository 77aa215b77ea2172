"""The min-sum decode kernel (``ops/msa_kernel.py`` -> ``csrc/msa_decode.cu``)
against its roofline: the bound of the window's decodes over the kernel's
device time. The iterations are the reference's mean per word on the words
it checked, times the window's words."""

from portbench import roofline


def read(ctx):
    t = ctx.device_s(lambda op: ctx.source(op) == "msa_decode.cu")
    ref = ctx.reference
    if t <= 0 or not ref.get("words"):
        return None
    iterations = ctx.words * ref["iterations"] / ref["words"]
    n_bytes, n_ops = roofline.msa_decode(ctx.words, iterations,
                                         ctx.graph["n_var"],
                                         ctx.graph["n_edge"])
    return 100.0 * roofline.bound_s(n_bytes, n_ops) / t
