"""Min-sum (``reference/minsum.py``) in the configuration's message type.

The control's messages are one type below the configuration's: float8
(e4m3) for bfloat16, bfloat16 for float32."""

import torch

from portbench.reference import minsum

# The program's min-sum keeps no iteration histogram.
TRACK_ITER_HIST = False

LOWER = {"bfloat16": "float8_e4m3fn", "float32": "bfloat16"}


def msg_dtype(run_config: dict) -> str:
    return run_config.get("msg_dtype", "float32")


def control_precision(run_config: dict) -> str:
    return LOWER[msg_dtype(run_config)]


def decoder(run_config: dict, tables, precision=None):
    dtype = getattr(torch, precision or msg_dtype(run_config))
    return lambda llr: minsum.decode(llr, tables, run_config["max_iter"],
                                     dtype)
