"""Channel models. Each module exposes ``send(x, param, generator)``,
``llr(y, param)`` and a ``DECODERS`` registry (name -> factory(code,
device=..., **kw)) of the decoders ported so far."""

from ldpc_decoders_tpu_torch.channels import bec, biawgn, bsc

CHANNELS = {"bec": bec, "biawgn": biawgn, "bsc": bsc}

# The JAX package's decoder names (the CLI accepts them and names the
# ROADMAP item of each one not ported yet).
DECODER_NAMES = ["ML", "SPA", "MSA", "LP", "ADMM", "ADMMA"]
