"""Pseudo-codeword search (counterpart of
``ldpc_decoders_tpu.decoders.pcw``): perturb a received word's LLRs and
collect the distinct fractional LP/ADMM fixed points.

All tries form one batch. For ADMM that is a single batched decode (the
CUDA kernel on a CUDA device, its plain version on the CPU); for LP the
batch goes through the vertex-enumeration path on the host. The host only
dedupes the (small) result set.
"""

from __future__ import annotations

import numpy as np


def dedupe_rows(rows: np.ndarray, tol: float = 1e-3,
                seeds: np.ndarray = None) -> np.ndarray:
    """Greedy reference-order dedupe: keep a row iff its max-abs distance
    to every kept (and seed) row exceeds tol."""
    kept = [np.asarray(s, np.float64) for s in
            (seeds if seeds is not None else [])]
    n_seed = len(kept)
    for z in np.asarray(rows, np.float64):
        if all(np.max(np.abs(z - u)) > tol for u in kept):
            kept.append(z)
    return np.array(kept[n_seed:]).reshape(-1, rows.shape[-1])


def find_pcws(code, y, decoder: str = "LP", tries: int = 1000,
              noise_scale: float = 1e-3, tol: float = 1e-3, seed: int = 0,
              mu: float = 3.0, eps: float = 1e-5,
              exclude=None, device="cuda") -> np.ndarray:
    """Distinct (pseudo-)codeword outputs of ``decoder`` around received
    word ``y`` (BSC-style LLR direction gamma = 1 - 2y, jittered).

    ``exclude``: optional rows (e.g. the transmitted codeword) that
    suppress matching outputs from the result. ``device`` is where the
    ADMM decode runs. Returns [M, n] float array (fractional rows are the
    pseudo-codewords)."""
    y = np.asarray(y, np.float64)
    rng = np.random.default_rng(seed)
    gammas = (1.0 - 2.0 * y)[None, :] + \
        rng.random((tries, y.size)) * noise_scale

    if decoder == "LP":
        from ldpc_decoders_tpu_torch.decoders.lp import LPDecoder
        dec = LPDecoder(code.graph, max_iter=-1, allow_pseudo=True)
        zs = dec.decode_batch(gammas)
    elif decoder == "ADMM":
        import torch

        from ldpc_decoders_tpu_torch.decoders.admm import ADMMDecoder
        dec = ADMMDecoder(code.graph, mu=mu, eps=eps, max_iter=-1,
                          allow_pseudo=True, device=device)
        x_hat, _ = dec.decode(torch.as_tensor(gammas, dtype=torch.float32,
                                              device=device))
        zs = x_hat.cpu().numpy().astype(np.float64)
    else:
        raise ValueError(f"unknown decoder {decoder!r} (LP or ADMM)")

    return dedupe_rows(zs, tol=tol, seeds=exclude)


def main(argv=None):
    import argparse

    from ldpc_decoders_tpu_torch.codes import get_code

    p = argparse.ArgumentParser(
        description="search pseudo-codewords around a received word")
    p.add_argument("code", help="code name, e.g. 7_4_hamming")
    p.add_argument("y", help="received word, e.g. 0,1,0,1,1,0,1")
    p.add_argument("--decoder", default="LP", choices=["LP", "ADMM"])
    p.add_argument("--tries", type=int, default=1000)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the ADMM decode: cuda (the CUDA "
                        "kernel) or cpu (the plain PyTorch version)")
    args = p.parse_args(argv)

    y = np.array([int(b) for b in args.y.split(",")])
    pcws = find_pcws(get_code(args.code), y, decoder=args.decoder,
                     tries=args.tries, tol=args.tol, seed=args.seed,
                     device=args.device)
    np.set_printoptions(linewidth=np.inf)
    for row in pcws:
        print(row)


if __name__ == "__main__":
    main()
