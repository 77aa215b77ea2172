"""Decoders (min-sum BP so far)."""
