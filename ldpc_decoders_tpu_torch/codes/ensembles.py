"""Random regular LDPC ensemble generation (counterpart of
``ldpc_decoders_tpu.codes.ensembles``).

The construction is the greedy min-fill column selection: for each check
row, pick the ``r`` variables with the smallest current degree, ties broken
uniformly at random, which gives an exactly (l, r)-regular H when n*l/r is
integral. The ``np.random.Generator`` calls are the JAX package's, one
``rng.random(n)`` per row, so the same seed gives the same H bit for bit
and the same files.

Usage (files go to the code registry's directory, ``FILE_CODES_DIR`` if
set):
    python -m ldpc_decoders_tpu_torch.codes.ensembles 10 1200 3 6 --seed 0
"""

from __future__ import annotations

import argparse

import numpy as np

from ldpc_decoders_tpu_torch.codes import code as code_mod


def rand_reg_ldpc(n: int, l: int, r: int,
                  rng: np.random.Generator | None = None) -> np.ndarray:
    """Random (n, l, r)-regular parity-check matrix of shape [n*l/r, n]."""
    if (n * l) % r != 0:
        raise ValueError("n*l must be divisible by r")
    rng = rng or np.random.default_rng()
    m = n * l // r
    H = np.zeros((m, n), dtype=np.int64)
    col_deg = np.zeros(n, dtype=np.int64)
    for i in range(m):
        # Smallest degree first, random tie-break: sort by (degree, key).
        order = np.lexsort((rng.random(n), col_deg))
        picked = order[:r]
        H[i, picked] = 1
        col_deg[picked] += 1
    assert (H.sum(axis=0) == l).all(), "column degrees not exactly l"
    assert (H.sum(axis=1) == r).all(), "row degrees not exactly r"
    return H


def gen_rand_reg_ldpc(count: int, n: int, l: int, r: int,
                      seed: int | None = None,
                      dir_path: str | None = None) -> list:
    """Generate and save ``count`` random codes named
    ``<n>_<l>_<r>_rand_ldpc_<i>`` (i from 1), all from one generator."""
    rng = np.random.default_rng(seed)
    names = []
    for i in range(count):
        H = rand_reg_ldpc(n, l, r, rng)
        name = f"{n}_{l}_{r}_rand_ldpc_{i + 1}"
        code_mod.save_parity_mtx(H, name, dir_path)
        names.append(name)
    return names


def main(argv=None):
    p = argparse.ArgumentParser(description="generate random regular LDPC codes")
    p.add_argument("count", type=int, help="number of random codes to generate")
    p.add_argument("n", type=int, help="code length")
    p.add_argument("l", type=int, help="variable degree")
    p.add_argument("r", type=int, help="check degree")
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)
    for name in gen_rand_reg_ldpc(args.count, args.n, args.l, args.r,
                                  args.seed):
        H = code_mod.get_code(name).parity_mtx
        print(name, H.shape, (H.sum(axis=0) == args.l).all(),
              (H.sum(axis=1) == args.r).all())


if __name__ == "__main__":
    main()
