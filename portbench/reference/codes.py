"""Parity-check files and the index tables of their Tanner graph.

A file holds one line per check, the 1-based (or 0-based) indices of its
variables. Edges are numbered row by row (check, then variable); a check's
slots follow that order, and a variable's slots follow the order of its
checks. The tables:

- ``chk_var`` [C, Dc]: the variable of each check slot (0 where padded),
  ``cmask`` [C, Dc] the real slots;
- ``var_slot`` [V, Dv]: the flat index ``c * Dc + d`` of each variable
  slot's edge in the check layout (0 where padded), ``vmask`` [V, Dv].
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def code_path(root: str, name: str) -> str:
    return os.path.join(root, "data", "codes", f"{name}.txt")


def load_parity(path: str) -> np.ndarray:
    """The dense 0/1 parity-check matrix [C, V] of a code file."""
    with open(path) as fp:
        rows = [[int(t) for t in ln.split()] for ln in fp if ln.split()]
    if not rows:
        raise ValueError(f"empty parity file: {path}")
    lo = min(min(r) for r in rows)
    if lo not in (0, 1):
        raise ValueError(f"{path}: the least variable index must be 0 or 1")
    n_var = max(max(r) for r in rows) + 1 - lo
    H = np.zeros((len(rows), n_var), dtype=np.int64)
    for c, r in enumerate(rows):
        H[c, np.asarray(r) - lo] = 1
    return H


@dataclasses.dataclass(frozen=True)
class Tables:
    chk_var: torch.Tensor     # [C, Dc] int64
    cmask: torch.Tensor       # [C, Dc] bool
    var_slot: torch.Tensor    # [V, Dv] int64
    vmask: torch.Tensor       # [V, Dv] bool
    n_var: int
    n_edge: int


def tables(H: np.ndarray, device) -> Tables:
    rows, cols = np.nonzero(H)                 # edges, row by row
    C, V = H.shape
    E = rows.size
    chk_deg = np.bincount(rows, minlength=C)
    var_deg = np.bincount(cols, minlength=V)
    dc, dv = int(chk_deg.max()), int(var_deg.max())
    row_start = np.concatenate([[0], np.cumsum(chk_deg)[:-1]])
    chk_slot = np.arange(E) - row_start[rows]
    chk_var = np.zeros((C, dc), dtype=np.int64)
    cmask = np.zeros((C, dc), dtype=bool)
    chk_var[rows, chk_slot] = cols
    cmask[rows, chk_slot] = True
    flat = rows * dc + chk_slot
    by_var = np.argsort(cols, kind="stable")   # a variable's edges by check
    col_start = np.concatenate([[0], np.cumsum(var_deg)[:-1]])
    var_rank = np.arange(E) - col_start[cols[by_var]]
    var_slot = np.zeros((V, dv), dtype=np.int64)
    vmask = np.zeros((V, dv), dtype=bool)
    var_slot[cols[by_var], var_rank] = flat[by_var]
    vmask[cols[by_var], var_rank] = True

    def dev(a):
        return torch.as_tensor(a, device=device)

    return Tables(dev(chk_var), dev(cmask), dev(var_slot), dev(vmask),
                  int(V), int(E))
