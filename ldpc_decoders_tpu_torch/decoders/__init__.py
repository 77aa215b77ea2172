"""Decoders: BP (min-sum, SPA) and its ensemble form, the erasure SPA,
ADMM, ML, LP and the pseudo-codeword search."""
