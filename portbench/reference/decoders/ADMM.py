"""ADMM LP decoding (``reference/admm.py``) in float32, to ``max_iter``
updates, or to convergence with ``iter_cap`` where ``max_iter`` is 0.

The control rounds the x-update's output, the solution plane x, to
bfloat16 (half its bytes), the rest float32: the plane a later change
would halve. ADMM wholly in bfloat16 never meets eps = 1e-5, so every
word would run to the cap."""

import torch

from portbench.reference import admm

# The program's ADMM keeps the 2000-bin iteration histogram.
TRACK_ITER_HIST = True


def control_precision(run_config: dict) -> str:
    return "bfloat16"


def decoder(run_config: dict, tables, precision=None):
    cap = (run_config["max_iter"] if run_config["max_iter"] > 0
           else run_config["iter_cap"])
    dtype = getattr(torch, precision or "float32")
    return lambda llr: admm.decode(llr, tables, mu=run_config["mu"],
                                   eps=run_config["eps"], max_iter=cap,
                                   x_dtype=dtype)
