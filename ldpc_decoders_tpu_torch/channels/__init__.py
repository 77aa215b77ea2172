"""Channel models. Each module exposes ``send(x, param, generator)``,
``llr(y, param)`` and a ``DECODERS`` registry (name -> factory(code,
device=..., **kw)). Only biAWGN is ported so far; BSC and BEC wait for
ROADMAP A.6."""

from ldpc_decoders_tpu_torch.channels import biawgn

CHANNELS = {"biawgn": biawgn}

# The JAX package's decoder names (the CLI accepts them and names the
# ROADMAP item of each one not ported yet).
DECODER_NAMES = ["ML", "SPA", "MSA", "LP", "ADMM", "ADMMA"]
