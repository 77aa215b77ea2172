"""Channel models. Each module exposes ``send(x, param, generator)``,
``llr(y, param)`` and a ``DECODERS`` registry (name -> factory(code,
device=..., **kw)). biAWGN and BSC are ported; BEC waits for ROADMAP
A.6."""

from ldpc_decoders_tpu_torch.channels import biawgn, bsc

CHANNELS = {"biawgn": biawgn, "bsc": bsc}

# The JAX package's decoder names (the CLI accepts them and names the
# ROADMAP item of each one not ported yet).
DECODER_NAMES = ["ML", "SPA", "MSA", "LP", "ADMM", "ADMMA"]
