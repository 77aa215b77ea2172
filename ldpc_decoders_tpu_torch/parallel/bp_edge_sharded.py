"""Edge-sharded BP: parity checks sharded over the ranks of a mesh's
``code`` axis (counterpart of ``ldpc_decoders_tpu.parallel.bp_edge_sharded``).

Each rank owns a contiguous slice of ``ceil(C / N)`` checks (the last
slices padded with inert slots, or empty), and with them its edges and
messages; the LLRs and marginals are replicated. Per iteration a rank
runs the check pass on its rows and sums its check-to-variable messages
per variable, and the ranks make ONE sum of those partial sums [B, V] over
the ``code`` axis (under the reference inf policy the three planes [B, 3,
V] of ``ldpc_decoders_tpu/parallel/bp_edge_sharded.py:ref_step``, still
one sum), then one sum of the words' odd-check counts for the syndrome.
Semantics are ``BPDecoder``'s: MSA, SPA under both inf policies,
``check_init``, the per-word freeze, iteration counts, ``max_iter <= 0``
bounded by ``iter_cap``; the LLRs are float32 and so are the messages, as
in the JAX module.

The check pass is plain PyTorch on the rank's device, the port's own row
functions (``ops/msa_kernel.py:msa_check_rows``,
``ops/spa_kernel.py:spa_check_rows`` / ``spa_check_rows_ref``), as the
JAX module runs XLA row functions and no Pallas kernel: the whole-loop CUDA
kernels cannot stop for a collective inside their loop. A variable's
partial sum adds its local slots one at a time in slot order (check
order), so one rank decodes bit for bit as ``BPDecoder``'s plain version
in float32; over several ranks only the grouping of those sums differs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ldpc_decoders_tpu_torch.ops.msa_kernel import msa_check_rows
from ldpc_decoders_tpu_torch.ops.spa_kernel import (
    INF_POLICIES,
    INF_S,
    NAN_S,
    _INF_MIN,
    _NAN_MIN,
    spa_check_rows,
    spa_check_rows_ref,
)


class ShardTables(NamedTuple):
    """Every rank's slice tables, stacked on a leading [n_dev] axis."""
    var_of_slot: torch.Tensor   # [n_dev, C_loc * Dc] int32; pads -> V
    mask: torch.Tensor          # [n_dev, C_loc, Dc] bool


def build_shard_tables(parity_mtx: np.ndarray, n_dev: int) -> ShardTables:
    """Check ``r`` goes to rank ``r // ceil(C / n_dev)``, its variables to
    the row's slots in column order (``build_shard_tables`` of the JAX
    module, as torch tensors on the CPU)."""
    H = np.asarray(parity_mtx)
    C, V = H.shape
    dc = int(H.sum(axis=1).max())
    c_loc = math.ceil(C / n_dev)
    var_of_slot = np.full((n_dev, c_loc * dc), V, dtype=np.int32)
    mask = np.zeros((n_dev, c_loc, dc), dtype=bool)
    for d in range(n_dev):
        for i, r in enumerate(range(d * c_loc, min((d + 1) * c_loc, C))):
            cols = np.nonzero(H[r])[0]
            var_of_slot[d, i * dc:i * dc + cols.size] = cols
            mask[d, i, :cols.size] = True
    return ShardTables(torch.from_numpy(var_of_slot), torch.from_numpy(mask))


def var_slot_table(var_of_slot: np.ndarray, n_var: int) -> np.ndarray:
    """[V, Dv_loc] int64: each variable's local slots in slot order, padded
    with the index of an appended zero slot (``var_of_slot.size``)."""
    n_slot = var_of_slot.size
    real = np.nonzero(var_of_slot < n_var)[0]
    owner = var_of_slot[real]
    counts = np.bincount(owner, minlength=n_var)
    table = np.full((n_var, max(1, int(counts.max(initial=0)))), n_slot,
                    dtype=np.int64)
    order = np.argsort(owner, kind="stable")       # slot order per variable
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank_in_var = np.arange(real.size) - starts[owner[order]]
    table[owner[order], rank_in_var] = real[order]
    return table


class EdgeShardedBPDecoder:
    """SPA/MSA with parity checks sharded over ``mesh``'s ``axis``.

    decode(llr [B, V]) -> (x_hat [B, V] int32, iters [B] int32), the same
    on every rank of the axis."""

    id_keys = ["max_iter"]

    def __init__(self, parity_mtx: np.ndarray, mesh, variant: str = "SPA",
                 max_iter: int = 10, iter_cap: int = 1000,
                 axis: str = "code", check_init: bool = True,
                 inf_policy: str = "reference", device=None, **_):
        if variant not in ("SPA", "MSA"):
            raise ValueError(f"unknown BP variant {variant!r}")
        if inf_policy not in INF_POLICIES:
            raise ValueError(f"unknown inf_policy {inf_policy!r}")
        H = np.asarray(parity_mtx)
        self.n_var = int(H.shape[1])
        self.mesh = mesh
        self.axis = axis
        self.variant = variant
        self.check_init = bool(check_init)
        self.max_iter = int(max_iter)
        self.iter_cap = self.max_iter if self.max_iter > 0 else int(iter_cap)
        # BPDecoder's default: SPA reproduces the reference's inf/NaN
        # cascade; its three class planes ride the one sum per iteration.
        self.inf_policy = inf_policy if variant == "SPA" else "saturate"
        self._check_rows = (spa_check_rows if variant == "SPA"
                            else msa_check_rows)
        n_dev = mesh.width(axis)
        tables = build_shard_tables(H, n_dev)
        d = mesh.index(axis)
        var_of_slot = tables.var_of_slot[d].numpy()
        dev = torch.device("cpu" if device is None else device)
        self.device = dev
        self.mask = tables.mask[d].to(dev)                       # [C_loc, Dc]
        self.var_of_slot = torch.from_numpy(
            var_of_slot.astype(np.int64)).to(dev)                # [C_loc*Dc]
        self.var_slot = torch.from_numpy(
            var_slot_table(var_of_slot, self.n_var)).to(dev)     # [V, Dv_loc]

    # -- the per-rank pieces of one iteration -----------------------------
    def _to_slots(self, per_var: torch.Tensor) -> torch.Tensor:
        """[B, V] -> [B, C_loc, Dc]; padded slots read a zero."""
        B = per_var.shape[0]
        padded = torch.cat([per_var, per_var.new_zeros((B, 1))], dim=1)
        return padded[:, self.var_of_slot].reshape((B,) + self.mask.shape)

    def _partial_sum(self, slots: torch.Tensor) -> torch.Tensor:
        """[B, ..., C_loc, Dc] -> [B, ..., V]: each variable's local slots
        added one at a time in slot order."""
        lead = slots.shape[:-2]
        flat = torch.where(self.mask, slots, 0.0).reshape(lead + (-1,))
        flat = torch.cat([flat, flat.new_zeros(lead + (1,))], dim=-1)
        acc = flat.new_zeros(lead + (self.n_var,))
        for s in range(self.var_slot.shape[1]):
            acc = acc + flat[..., self.var_slot[:, s]]
        return acc

    def _sum_per_var(self, slots: torch.Tensor) -> torch.Tensor:
        """The global per-variable sums: ONE sum over the code axis."""
        return self.mesh.all_reduce(self._partial_sum(slots), self.axis)

    def _syndrome_ok(self, x_hat: torch.Tensor) -> torch.Tensor:
        """[B, V] int32 -> [B] bool: no check of any rank is odd."""
        bits = torch.where(self.mask, self._to_slots(x_hat), 0)
        odd = (bits.sum(dim=-1) % 2).sum(dim=-1).to(torch.int32)
        return self.mesh.all_reduce(odd, self.axis) == 0

    def _ref_step(self, llr: torch.Tensor, v2c: torch.Tensor) -> tuple:
        """One reference-policy SPA iteration: the sentinel classes of
        ``spa_decode_plain`` with its three variable sums (finite part,
        +inf-or-NaN count, -inf-or-NaN count) stacked into one sum."""
        c2v = spa_check_rows_ref(v2c, self.mask)
        nan_i = c2v > _NAN_MIN
        pinf_i = (c2v > _INF_MIN) & ~nan_i
        ninf_i = c2v < -_INF_MIN
        fin_v = torch.where(nan_i | pinf_i | ninf_i, 0.0, c2v)
        planes = torch.stack([fin_v, (pinf_i | nan_i).to(torch.float32),
                              (ninf_i | nan_i).to(torch.float32)], dim=1)
        sums = self._sum_per_var(planes)                         # [B, 3, V]
        fin_sum, n_p, n_n = sums[:, 0], sums[:, 1], sums[:, 2]
        is_nan = (n_p > 0.5) & (n_n > 0.5)
        is_p = ~is_nan & (n_p > 0.5)
        is_n = ~is_nan & (n_n > 0.5)
        marg_fin = llr + fin_sum
        x_new = torch.where(is_n, 1, torch.where(
            is_nan | is_p, 0, (marg_fin < 0).to(torch.int32)))
        marg_enc = torch.where(is_nan, NAN_S, torch.where(
            is_p, INF_S, torch.where(is_n, -INF_S, marg_fin)))
        edge_m = self._to_slots(marg_enc)
        em_nan = edge_m > _NAN_MIN
        em_p = (edge_m > _INF_MIN) & ~em_nan
        em_n = edge_m < -_INF_MIN
        v2c_new = torch.where(em_p, torch.where(pinf_i, NAN_S, INF_S),
                              edge_m - fin_v)
        v2c_new = torch.where(em_n, torch.where(ninf_i, NAN_S, -INF_S),
                              v2c_new)
        v2c_new = torch.where(em_nan, NAN_S, v2c_new)
        return x_new.to(torch.int32), torch.where(self.mask, v2c_new, 0.0)

    def decode(self, llr: torch.Tensor) -> tuple:
        llr = llr.to(device=self.device, dtype=torch.float32)
        B = llr.shape[0]
        x_hat = (llr < 0).to(torch.int32)
        done = (self._syndrome_ok(x_hat) if self.check_init
                else torch.zeros(B, dtype=torch.bool, device=self.device))
        v2c = torch.where(self.mask, self._to_slots(llr), 0.0)
        iters = torch.zeros(B, dtype=torch.int32, device=self.device)
        for _ in range(self.iter_cap):
            if bool(done.all()):     # done is the same on every rank
                break
            if self.inf_policy == "reference":
                x_new, v2c_new = self._ref_step(llr, v2c)
            else:
                c2v = self._check_rows(v2c, self.mask)
                marginal = llr + self._sum_per_var(c2v)
                v2c_new = torch.where(self.mask,
                                      self._to_slots(marginal) - c2v, 0.0)
                x_new = (marginal < 0).to(torch.int32)
            active = ~done
            x_hat = torch.where(active[:, None], x_new, x_hat)
            v2c = torch.where(active[:, None, None], v2c_new, v2c)
            iters += active.to(torch.int32)
            done = done | self._syndrome_ok(x_hat)
        return x_hat, iters
