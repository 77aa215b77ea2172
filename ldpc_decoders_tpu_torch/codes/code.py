"""Linear block code model, built-in codes and parity file I/O
(counterpart of ``ldpc_decoders_tpu.codes.code``).

- ``Code`` holds generator + parity matrices and, when a generator is
  given, the enumerated codebook with its GH^T = 0 check;
- the same four built-in codes;
- the same text parity file format: one line per check, whitespace
  separated 1-based (or 0-based) variable indices;
- the ``FILE_CODES_DIR`` environment override.

``Code.graph`` compiles the parity matrix into CPU edge tables
(:class:`~ldpc_decoders_tpu_torch.ops.graph.TannerGraph`); decoders move
them to their device with ``graph.to(device)``.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np

from ldpc_decoders_tpu_torch.ops.graph import TannerGraph
from ldpc_decoders_tpu_torch.utils.math import binary_vectors

FILE_CODES_DIR_ENV = "FILE_CODES_DIR"


def file_codes_dir() -> str:
    """FILE_CODES_DIR env override, else the repo's own data/codes, else
    cwd-relative data/codes."""
    env = os.environ.get(FILE_CODES_DIR_ENV)
    if env:
        return os.path.abspath(env)
    repo_default = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "data", "codes")
    if os.path.isdir(repo_default):
        return repo_default
    return os.path.abspath(os.path.join("data", "codes"))


class Code:
    """A binary linear code given by (optional) generator and parity matrices."""

    def __init__(self, gen_mtx: Optional[np.ndarray], parity_mtx: np.ndarray):
        self.gen_mtx = None if gen_mtx is None else np.asarray(gen_mtx, dtype=np.int64)
        self.parity_mtx = np.asarray(parity_mtx, dtype=np.int64)
        self._graph: Optional[TannerGraph] = None

        if self.gen_mtx is not None:
            k, n = self.gen_mtx.shape
            self.cb = (binary_vectors(k) @ self.gen_mtx) % 2
            if ((self.cb @ self.parity_mtx.T) % 2).sum() != 0:
                raise ValueError("generator does not satisfy G H^T = 0")
            if self.cb[0].sum() != 0:
                raise ValueError("codebook missing the all-zeros codeword")
        else:
            self.cb = None

    def get_n(self) -> int:
        return self.parity_mtx.shape[1]

    def get_k(self) -> int:
        return self.get_n() - self.parity_mtx.shape[0]

    @property
    def graph(self) -> TannerGraph:
        """Compiled edge tables on the CPU (cached)."""
        if self._graph is None:
            self._graph = TannerGraph.from_parity_mtx(self.parity_mtx)
        return self._graph

    def __repr__(self) -> str:
        return f"Code(n={self.get_n()}, checks={self.parity_mtx.shape[0]})"


def _builtin_codes():
    test_4_2 = (
        np.array([[1, 1, 1, 0, 0],
                  [0, 0, 1, 1, 1]]),
        np.array([[1, 1, 0, 0, 0],
                  [0, 1, 1, 1, 0],
                  [0, 0, 0, 1, 1]]),
    )
    ldpc_6_2_3 = (
        np.array([[0, 0, 0, 1, 0, 1],
                  [1, 0, 1, 1, 1, 0],
                  [1, 1, 0, 0, 0, 0]]),
        np.array([[1, 1, 1, 0, 0, 0],
                  [0, 0, 0, 1, 1, 1],
                  [0, 0, 1, 1, 0, 1],
                  [1, 1, 0, 0, 1, 0]]),
    )
    hamming_7_4 = (
        np.array([[1, 1, 1, 0, 0, 0, 0],
                  [1, 0, 0, 1, 1, 0, 0],
                  [0, 1, 0, 1, 0, 1, 0],
                  [1, 1, 0, 1, 0, 0, 1]]),
        np.array([[0, 0, 0, 1, 1, 1, 1],
                  [0, 1, 1, 0, 0, 1, 1],
                  [1, 0, 1, 0, 1, 0, 1]]),
    )
    ldpc_12_3_4 = (
        np.array([[0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1],
                  [0, 0, 0, 1, 0, 0, 1, 1, 1, 1, 1, 0],
                  [0, 0, 1, 0, 0, 1, 0, 0, 0, 1, 1, 0],
                  [0, 1, 0, 0, 0, 1, 0, 1, 1, 0, 1, 1],
                  [1, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 1]]),
        np.array([[0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 0, 0],
                  [1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1],
                  [0, 0, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0],
                  [0, 1, 0, 0, 0, 1, 1, 0, 0, 1, 0, 0],
                  [1, 0, 1, 0, 0, 0, 0, 1, 0, 0, 1, 0],
                  [0, 0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 1],
                  [1, 0, 0, 1, 1, 0, 1, 0, 0, 0, 0, 0],
                  [0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 1, 1],
                  [0, 1, 1, 0, 0, 0, 0, 0, 1, 1, 0, 0]]),
    )
    return {
        "4_2_test": test_4_2,
        "6_2_3_ldpc": ldpc_6_2_3,
        "7_4_hamming": hamming_7_4,
        "12_3_4_ldpc": ldpc_12_3_4,
    }


BUILTIN_CODES = _builtin_codes()


def _file_code_map() -> dict:
    d = file_codes_dir()
    try:
        files = next(os.walk(d))[2]
    except StopIteration:
        files = []
    return {os.path.splitext(f)[0]: os.path.join(d, f) for f in files}


def get_code_names() -> list:
    return list(BUILTIN_CODES.keys()) + sorted(_file_code_map().keys())


@functools.lru_cache(maxsize=64)
def _get_code_cached(name: str, path: Optional[str],
                     mtime: Optional[float]) -> Code:
    # mtime is part of the key so a regenerated file is reloaded.
    del mtime
    if path is not None:
        return Code(None, load_parity_mtx(path))
    return Code(*BUILTIN_CODES[name])


def get_code(name: str) -> Code:
    """Look up a code by name; a file of that name wins over a built-in."""
    fmap = _file_code_map()
    if name in fmap:
        path = fmap[name]
        return _get_code_cached(name, path, os.path.getmtime(path))
    if name in BUILTIN_CODES:
        return _get_code_cached(name, None, None)
    raise KeyError(f"unknown code {name!r}; known: {get_code_names()}")


def load_parity_mtx(file_path: str) -> np.ndarray:
    """Parse 'one line per check, 1-based (or 0-based) var indices'."""
    with open(file_path, "r") as fp:
        rows = [list(map(int, ln.split())) for ln in fp if ln.split()]
    if not rows:
        raise ValueError(f"empty parity file: {file_path}")
    lo = min(min(r) for r in rows)
    hi = max(max(r) for r in rows)
    if lo not in (0, 1):
        raise ValueError("minimum variable index must be 0 or 1")
    n_var = hi + (1 if lo == 0 else 0)
    H = np.zeros((len(rows), n_var), dtype=np.int64)
    for i, r in enumerate(rows):
        H[i, np.asarray(r) - lo] = 1
    return H


def save_parity_mtx(parity_mtx: np.ndarray, code_name: str,
                    dir_path: Optional[str] = None) -> str:
    d = dir_path or file_codes_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{code_name}.txt")
    with open(path, "w") as fp:
        for row in np.asarray(parity_mtx):
            idx = np.nonzero(row)[0] + 1  # 1-based, like the reference
            fp.write(" ".join(map(str, idx)) + "\n")
    return path
