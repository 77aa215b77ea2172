"""Batched Euclidean projection onto the parity polytope (counterpart of
``ldpc_decoders_tpu.ops.projection``), in plain PyTorch.

The parity polytope PP_d is the convex hull of the even-weight binary
vectors in {0,1}^d; projecting every check's row onto it is the inner step
of ADMM LP decoding. The algorithm is the JAX package's sort-free one:

1. descending rank of each coordinate by pairwise comparison, ties broken
   by index (the rank in a stable sort);
2. cube-clip; r = the even floor of the clipped sum; the facet normal f is
   +1 on the r+1 largest coordinates and -1 elsewhere;
3. if f.z <= r the cube projection already lies in PP_d;
4. otherwise the answer is clip(v - beta*f, 0, 1) with T(beta) =
   f.clip(v - beta*f, 0, 1) = r. T is piecewise linear and non-increasing
   and each of its breakpoints is one of 2d candidates, so T is evaluated
   at all of them (and at beta = 0), r is bracketed between the largest
   candidate with T >= r and the smallest with T <= r, and beta is
   interpolated linearly between the two.

A padded slot is filled with a value below any reachable breakpoint and
projects to exactly 0, so rows of mixed degree need no bucketing.

Every sum over a row's slots is a fold in slot order (slot 0 first), never
``torch.sum``, whose association is not fixed: the CUDA kernel
``csrc/admm_decode.cu`` folds in the same order, and the two agree bit for
bit on the card.
"""

from __future__ import annotations

from typing import Optional

import torch


def fold_slots(x: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis, slot 0 first, one slot at a time."""
    acc = x[..., 0]
    for d in range(1, x.shape[-1]):
        acc = acc + x[..., d]
    return acc


def project_parity_polytope(v: torch.Tensor,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Project rows of v [..., D] onto the parity polytope PP_D.

    mask [..., D] bool marks real slots (True) against padding; padded
    slots project to exactly 0."""
    D = v.shape[-1]
    if mask is not None:
        pad_val = -((v.abs() * mask).amax(dim=-1, keepdim=True) + 4.0)
        v = torch.where(mask, v, pad_val)

    # Descending rank with index tie-break (integer counts: exact).
    idx = torch.arange(D, device=v.device)
    v_e, v_d = v[..., None, :], v[..., :, None]
    gt = (v_e > v_d) | ((v_e == v_d) & (idx[None, :] < idx[:, None]))
    rank = gt.sum(dim=-1).to(v.dtype)                           # [..., D]

    z = v.clamp(0.0, 1.0)
    s = torch.floor(fold_slots(z))
    r = s - torch.remainder(s, 2.0)                             # even floor
    f = torch.where(rank <= r[..., None], 1.0, -1.0).to(v.dtype)
    fz = fold_slots(f * z)
    easy = fz <= r                                              # inside PP_D

    # T at the 2D candidate breakpoints (clamped into beta >= 0) and at
    # beta = 0, where T = fz. Top coordinates shift by -beta, the others
    # by +beta.
    top = f > 0
    cand = torch.cat([torch.where(top, v - 1.0, -v),
                      torch.where(top, v, 1.0 - v)], dim=-1).clamp_min(0.0)
    T = None                                                    # [..., 2D]
    for d in range(D):
        f_d = f[..., d:d + 1]
        term = f_d * (v[..., d:d + 1] - cand * f_d).clamp(0.0, 1.0)
        T = term if T is None else T + term
    cand = torch.cat([cand, torch.zeros_like(cand[..., :1])], dim=-1)
    T = torch.cat([T, fz[..., None]], dim=-1)                   # [..., 2D+1]

    rr = r[..., None]
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    # T has no breakpoint strictly between lo and hi, so it is linear
    # there. max and min are exact, so their order does not matter.
    lo = torch.where(T >= rr, cand, 0.0).amax(dim=-1)
    hi = torch.where(T <= rr, cand, inf).amin(dim=-1)
    t_lo = torch.where(cand == lo[..., None], T, -inf).amax(dim=-1)
    t_hi = torch.where(cand == hi[..., None], T, inf).amin(dim=-1)

    denom = t_lo - t_hi
    ok = denom > 0
    beta = torch.where(
        ok, lo + (t_lo - r) * (hi - lo) / torch.where(ok, denom, 1.0), lo)
    out = torch.where(easy[..., None], z,
                      (v - beta[..., None] * f).clamp(0.0, 1.0))
    if mask is not None:
        out = torch.where(mask, out, 0.0)
    return out


def project_check_rows(graph, v_edges: torch.Tensor) -> torch.Tensor:
    """Project every check's edge slice of v [..., E] onto its PP_deg:
    gather to the [..., C, Dc] layout, project all rows at once (padding
    handled by ``chk_mask``), scatter back to edge order."""
    fill = torch.zeros_like(v_edges[..., :1])
    rows = torch.cat([v_edges, fill], dim=-1)[..., graph.chk_edge.long()]
    proj = project_parity_polytope(rows, mask=graph.chk_mask)
    flat = proj.reshape(proj.shape[:-2] + (-1,))
    return flat[..., graph.edge_in_chk.long()]
