"""LT (Luby transform) fountain codes (counterpart of
``ldpc_decoders_tpu.fountain``)."""

from ldpc_decoders_tpu_torch.fountain.lt import (  # noqa: F401
    LTSimulator,
    ideal_soliton,
    robust_soliton,
)
