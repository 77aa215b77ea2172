"""Decoders: BP (min-sum, SPA) and its ensemble form, the erasure SPA,
ADMM and ADMMA (its learned projection), ML, LP and the pseudo-codeword
search."""
