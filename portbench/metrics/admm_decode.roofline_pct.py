"""The ADMM decode kernel (``ops/admm_kernel.py`` -> ``csrc/admm_decode.cu``)
against its roofline, counting the word updates only (a floor). The updates
are the runner's own iteration histograms over the window's points; the
words in the last bin (counts of 1999 and above) count at the reference's
mean over the words of that bin it decoded, or at 1999 where it met
none."""

import numpy as np

from portbench import roofline


def read(ctx):
    t = ctx.device_s(lambda op: ctx.source(op) == "admm_decode.cu")
    hists = [p["hist"] for p in ctx.points if p.get("hist")]
    if t <= 0 or not hists:
        return None
    hist = np.sum(np.asarray(hists, dtype=np.float64), axis=0)
    last = hist.size - 1
    ref = ctx.reference
    tail = (ref["tail_iterations"] / ref["tail_words"]
            if ref.get("tail_words") else last)
    updates = float(hist[:last] @ np.arange(last)) + hist[last] * tail
    g = ctx.graph
    n_bytes, n_ops = roofline.admm_decode(ctx.words, updates, g["n_var"],
                                          g["n_edge"], g["dc"])
    return 100.0 * roofline.bound_s(n_bytes, n_ops) / t
