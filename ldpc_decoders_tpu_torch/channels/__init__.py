"""Channel models. Each module exposes ``send(x, param, generator)``,
``llr(y, param)`` and a ``DECODERS`` registry (name -> factory(code,
device=..., **kw)) of its decoders."""

from ldpc_decoders_tpu_torch.channels import bec, biawgn, bsc

CHANNELS = {"bec": bec, "biawgn": biawgn, "bsc": bsc}

# The JAX package's decoder names, every one in each channel's DECODERS.
DECODER_NAMES = ["ML", "SPA", "MSA", "LP", "ADMM", "ADMMA"]
