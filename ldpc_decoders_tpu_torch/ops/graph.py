"""Static edge-table representation of a Tanner graph (counterpart of
``ldpc_decoders_tpu.ops.graph``).

The tables are built once in numpy, in exactly the JAX package's layout,
and held as torch tensors on an explicit ``device``:

- edges are numbered in CSR order (sorted by check row, then variable);
- ``chk_edge`` [C, Dc] / ``var_edge`` [V, Dv] list each node's edge ids,
  padded to the maximum degree with the sentinel ``n_edge``;
- ``var_slot_from_chk`` / ``chk_slot_from_var`` map a slot of one padded
  layout to the flat index of the same edge in the other (sentinel: the
  other layout's size, i.e. an appended fill slot).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# Integer table fields, in declaration order (shared by the numpy-dict
# conversions below).
_TENSOR_FIELDS = (
    "edge_chk", "edge_var", "chk_edge", "chk_mask", "var_edge", "var_mask",
    "chk_deg", "var_deg", "edge_in_chk", "edge_in_var",
    "var_slot_from_chk", "chk_slot_from_var",
)
_INT_FIELDS = ("n_chk", "n_var", "n_edge", "max_chk_deg", "max_var_deg")


@dataclasses.dataclass(frozen=True, eq=False)
class TannerGraph:
    """Compiled, immutable edge tables for one parity-check matrix."""

    n_chk: int
    n_var: int
    n_edge: int
    edge_chk: torch.Tensor           # [E] int32, CSR order
    edge_var: torch.Tensor           # [E] int32
    chk_edge: torch.Tensor           # [C, Dc] int32, padded with n_edge
    chk_mask: torch.Tensor           # [C, Dc] bool
    var_edge: torch.Tensor           # [V, Dv] int32, padded with n_edge
    var_mask: torch.Tensor           # [V, Dv] bool
    chk_deg: torch.Tensor            # [C] int32
    var_deg: torch.Tensor            # [V] int32
    max_chk_deg: int
    max_var_deg: int
    edge_in_chk: torch.Tensor        # [E] int32 into flat [C*Dc]
    edge_in_var: torch.Tensor        # [E] int32 into flat [V*Dv]
    var_slot_from_chk: torch.Tensor  # [V*Dv] int32 into flat [C*Dc]+fill
    chk_slot_from_var: torch.Tensor  # [C*Dc] int32 into flat [V*Dv]+fill
    chk_degrees: tuple
    device: torch.device

    @staticmethod
    def from_parity_mtx(parity_mtx: np.ndarray,
                        device="cpu") -> "TannerGraph":
        """Compile a dense 0/1 parity-check matrix H of shape [C, V]."""
        H = np.asarray(parity_mtx)
        n_chk, n_var = H.shape
        rows, cols = np.nonzero(H)     # row-major: CSR edge order
        E = rows.size

        def build_side(node_of_edge: np.ndarray, n_nodes: int):
            deg = np.bincount(node_of_edge, minlength=n_nodes).astype(np.int32)
            dmax = int(deg.max()) if E else 1
            # Slot of each edge = its rank among its node's edges, in edge
            # order (a stable sort keeps CSR order within a node).
            order = np.argsort(node_of_edge, kind="stable")
            starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
            slot = np.empty(E, dtype=np.int64)
            slot[order] = np.arange(E) - starts[node_of_edge[order]]
            table = np.full((n_nodes, dmax), E, dtype=np.int32)
            table[node_of_edge, slot] = np.arange(E, dtype=np.int32)
            inv = (node_of_edge * dmax + slot).astype(np.int32)
            return deg, dmax, table, table != E, inv

        chk_deg, dc, chk_edge, chk_mask, edge_in_chk = build_side(rows, n_chk)
        var_deg, dv, var_edge, var_mask, edge_in_var = build_side(cols, n_var)

        def compose(inv_a, slots_a, edge_in_b, sentinel_b):
            # Slot of layout a -> flat index of the same edge in layout b.
            out = np.full(slots_a, sentinel_b, dtype=np.int32)
            out[inv_a] = edge_in_b
            return out

        return TannerGraph.from_jax_graph(dict(
            n_chk=n_chk, n_var=n_var, n_edge=E,
            edge_chk=rows.astype(np.int32), edge_var=cols.astype(np.int32),
            chk_edge=chk_edge, chk_mask=chk_mask,
            var_edge=var_edge, var_mask=var_mask,
            chk_deg=chk_deg, var_deg=var_deg,
            max_chk_deg=dc, max_var_deg=dv,
            edge_in_chk=edge_in_chk, edge_in_var=edge_in_var,
            var_slot_from_chk=compose(edge_in_var, n_var * dv, edge_in_chk,
                                      n_chk * dc),
            chk_slot_from_var=compose(edge_in_chk, n_chk * dc, edge_in_var,
                                      n_var * dv),
        ), device=device)

    @staticmethod
    def from_jax_graph(tables: dict, device="cpu") -> "TannerGraph":
        """Build from the JAX package's ``TannerGraph`` fields given as a
        dict of numpy arrays and ints (``{f: np.asarray(getattr(g, f))}``),
        so tests can feed both packages the same tables."""
        dev = torch.device(device)
        t = {k: torch.as_tensor(np.array(tables[k]), device=dev)
             for k in _TENSOR_FIELDS}
        for k in ("chk_mask", "var_mask"):
            t[k] = t[k].to(torch.bool)
        for k in set(_TENSOR_FIELDS) - {"chk_mask", "var_mask"}:
            t[k] = t[k].to(torch.int32)
        ints = {k: int(tables[k]) for k in _INT_FIELDS}
        chk_degrees = tuple(sorted(set(
            int(d) for d in np.asarray(tables["chk_deg"]))))
        return TannerGraph(**ints, **t, chk_degrees=chk_degrees, device=dev)

    def as_numpy_dict(self) -> dict:
        """The tables as numpy arrays and ints (``from_jax_graph``'s input)."""
        out = {k: getattr(self, k) for k in _INT_FIELDS}
        out.update({k: getattr(self, k).cpu().numpy() for k in _TENSOR_FIELDS})
        return out

    def to(self, device) -> "TannerGraph":
        """The same tables on ``device``."""
        dev = torch.device(device)
        if dev == self.device:
            return self
        return dataclasses.replace(
            self, device=dev,
            **{k: getattr(self, k).to(dev) for k in _TENSOR_FIELDS})


class BPTables(NamedTuple):
    """Index tables of one graph for the BP decoders' two routes (plain
    PyTorch and CUDA kernel), on the graph's device."""
    chk_var: torch.Tensor    # [C, Dc] int64 variable of each check slot (pad 0)
    cmask: torch.Tensor      # [C, Dc] bool
    var_slot: torch.Tensor   # [V, Dv] int64 flat c*Dc+d of each var slot (pad 0)
    vmask: torch.Tensor      # [V, Dv] bool
    k_chk_var: torch.Tensor  # [Dc, C] int32, -1 = pad (kernel, slot-major)
    k_var_slot: torch.Tensor  # [Dv, V] int32 into slot-major [Dc, C], -1 = pad
    chk_full: bool           # no check slot is padded
    var_full: bool           # no variable slot is padded


def bp_tables(graph: TannerGraph) -> BPTables:
    g = graph
    C, V, Dc = g.n_chk, g.n_var, g.max_chk_deg
    cmask = g.chk_mask.cpu().numpy()
    vmask = g.var_mask.cpu().numpy()
    edge_var = np.append(g.edge_var.cpu().numpy(), 0)      # sentinel E -> 0
    chk_var = np.where(cmask, edge_var[g.chk_edge.cpu().numpy()], 0)
    var_slot = np.where(
        vmask, g.var_slot_from_chk.cpu().numpy().reshape(V, -1), 0)
    k_var_slot = np.where(vmask, (var_slot % Dc) * C + var_slot // Dc, -1)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=g.device)

    return BPTables(
        chk_var=dev(chk_var, torch.int64), cmask=dev(cmask, torch.bool),
        var_slot=dev(var_slot, torch.int64), vmask=dev(vmask, torch.bool),
        k_chk_var=dev(np.where(cmask, chk_var, -1).T, torch.int32),
        k_var_slot=dev(k_var_slot.T, torch.int32),
        chk_full=bool(cmask.all()), var_full=bool(vmask.all()))


def syndrome_ok(x_hat: torch.Tensor, t: BPTables) -> torch.Tensor:
    """[B, V] bool bits -> [B] bool: every check's XOR is 0."""
    bits = (x_hat[:, t.chk_var] & t.cmask).to(torch.int32)
    return (bits.sum(dim=-1) % 2 == 0).all(dim=-1)


def exclusive_sum(x: torch.Tensor) -> torch.Tensor:
    """Leave-one-out sum along the last axis as prefix + suffix. Both
    partial sums start from 0 and add one slot at a time in slot order
    (the prefix from the first slot up, the suffix from the last slot
    down): no ``torch.cumsum``, whose association is not fixed. The CUDA
    SPA kernel folds in the same order, so the two are bit-equal."""
    d = x.shape[-1]
    zero = torch.zeros_like(x[..., 0])
    pre, suf = [zero], [zero]
    for i in range(d - 1):
        pre.append(pre[-1] + x[..., i])
    for i in range(d - 1, 0, -1):
        suf.insert(0, suf[0] + x[..., i])
    return torch.stack([p + s for p, s in zip(pre, suf)], dim=-1)


def exclusive_min(x: torch.Tensor) -> torch.Tensor:
    """Leave-one-out min along the last axis as min(prefix, suffix); +inf
    where a row has one slot. min is exact, so its order does not matter."""
    inf = torch.full_like(x[..., :1], float("inf"))
    if x.shape[-1] == 1:
        return inf
    prefix = torch.cat([inf, torch.cummin(x, dim=-1).values[..., :-1]],
                       dim=-1)
    suffix = torch.cat([torch.cummin(x.flip(-1), dim=-1).values.flip(-1)
                        [..., 1:], inf], dim=-1)
    return torch.minimum(prefix, suffix)


def exclusive_sign_parity(neg: torch.Tensor) -> torch.Tensor:
    """Leave-one-out sign product along the last axis from a 0/1
    negativity mask, as negative-count parity. Returns int +-1."""
    excl = neg.sum(dim=-1, keepdim=True) - neg   # exact: integer counts
    return 1 - 2 * (excl % 2)
