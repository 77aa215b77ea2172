"""Monte-Carlo experiment harness: sweep runners, adaptive termination and
result persistence."""

from ldpc_decoders_tpu_torch.harness.cap_sweep import CapSweepRunner  # noqa: F401
from ldpc_decoders_tpu_torch.harness.runner import (  # noqa: F401
    MonteCarloRunner,
    RunConfig,
)
from ldpc_decoders_tpu_torch.harness.saver import Saver  # noqa: F401
