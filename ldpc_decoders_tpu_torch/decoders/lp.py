"""Feldman LP decoding (counterpart of ``ldpc_decoders_tpu.decoders.lp``).

A host decoder, in numpy and scipy, in the JAX package too: the harness
samples on the device, decodes here on the host and tallies the same
packed vector (``MonteCarloRunner._host_chunk``). It is no CPU stand-in
for a device decoder.

The LP relaxation has 2^(deg-1) forbidden-set constraints per check, so it
is practical only for short codes (Hamming scale). Constraint system: for
every check c and every odd-cardinality subset S of its neighbourhood N(c):
sum_{i in S} x_i - sum_{i in N(c)\\S} x_i <= |S|-1, with 0 <= x <= 1;
objective min gamma.x (gamma = channel LLRs).

Two solve paths:

- **vertex**: the fundamental polytope of a Hamming-scale code has a small
  vertex set; enumerating it once (Qhull halfspace intersection) turns
  every decode into an argmin of ``V @ gamma``. Tie faces are resolved by
  the centre of the optimal face (mean of its minimizing vertices), which
  feeds ``pseudo_to_cw``, so a fractional tie thresholds like scipy's
  interior-point solve.
- **linprog**: scipy HiGHS per distinct received word, for longer codes
  and as the oracle the vertex path is tested against.

Tie-degeneracy note: single-bit-flip BSC words sit on exact objective ties
between the codeword and fractional pseudo-codewords, so in the small-p
regime WER is a tie-break convention; the face centre decodes 3 of the 7
flip positions of Hamming(7,4) wrong where the reference's committed
golden implies 2 of 7. Away from that tail the curves agree within
Monte-Carlo confidence on all three channels.
"""

from __future__ import annotations

import numpy as np

from ldpc_decoders_tpu_torch.utils.math import binary_vectors, pseudo_to_cw

# Vertex enumeration is exponential in the dimension: Hamming scale only.
# Checks of degree <= 2 collapse the polytope's interior (x_i = x_j), which
# Qhull's halfspace mode cannot seed; those codes use the linprog path.
VERTEX_ENUM_MAX_VARS = 10


def build_constraints(parity_mtx: np.ndarray) -> tuple:
    """Stack the odd-subset constraints for all checks: (A_ub, b_ub)."""
    H = np.asarray(parity_mtx)
    blocks, bounds = [], []
    for row in H:
        nbr = np.flatnonzero(row)
        subsets = binary_vectors(nbr.size)
        odd = subsets[subsets.sum(axis=1) % 2 == 1]
        block = np.zeros((odd.shape[0], H.shape[1]), dtype=np.int64)
        block[:, nbr] = 2 * odd - 1
        blocks.append(block)
        bounds.append(odd.sum(axis=1) - 1)
    return np.concatenate(blocks, axis=0), np.concatenate(bounds, axis=0)


def enumerate_polytope_vertices(a_ub: np.ndarray,
                                b_ub: np.ndarray) -> np.ndarray:
    """All vertices of {x: a_ub x <= b_ub, 0 <= x <= 1} via Qhull.

    The all-0.5 point is strictly interior whenever every check degree
    is >= 3 (constraint slack |S| - d/2 < |S| - 1 iff d > 2)."""
    from scipy.spatial import HalfspaceIntersection

    n = a_ub.shape[1]
    eye = np.eye(n)
    # Halfspace rows in Qhull form [A | -b] for A x <= b.
    A = np.concatenate([a_ub, -eye, eye], axis=0).astype(np.float64)
    b = np.concatenate([b_ub, np.zeros(n), np.ones(n)]).astype(np.float64)
    hs = np.concatenate([A, -b[:, None]], axis=1)
    interior = np.full(n, 0.5)
    if not (A @ interior < b - 1e-9).all():
        raise ValueError("no strict interior at 0.5 (degree<=2 check?)")
    inter = HalfspaceIntersection(hs, interior)
    verts = np.unique(np.round(inter.intersections, 12), axis=0)
    return np.clip(verts, 0.0, 1.0)


class LPDecoder:
    """Host-side Feldman LP decoder over a compiled Tanner graph."""

    id_keys = ["max_iter", "allow_pseudo"]
    host_only = True

    def __init__(self, graph, max_iter: int = 10, allow_pseudo: bool = False,
                 **_):
        self.graph = graph
        self.max_iter = int(max_iter)
        self.allow_pseudo = bool(allow_pseudo)
        H = np.zeros((graph.n_chk, graph.n_var), dtype=np.int64)
        H[graph.edge_chk.cpu().numpy(), graph.edge_var.cpu().numpy()] = 1
        self.a_ub, self.b_ub = build_constraints(H)
        self.vertices = None
        if (graph.n_var <= VERTEX_ENUM_MAX_VARS
                and H.sum(axis=1).min() >= 3):
            self.vertices = enumerate_polytope_vertices(self.a_ub, self.b_ub)

    # -- linprog path (oracle / long codes) --------------------------------
    def decode_one(self, gamma: np.ndarray) -> np.ndarray:
        from scipy.optimize import linprog

        res = linprog(gamma, A_ub=self.a_ub, b_ub=self.b_ub, bounds=(0, 1),
                      method="highs")
        return pseudo_to_cw(res.x, self.allow_pseudo, eps=1e-4)

    def _decode_batch_linprog(self, gammas: np.ndarray) -> np.ndarray:
        # Discrete channels repeat LLR vectors heavily within a batch;
        # solve each distinct vector once.
        uniq, inv = np.unique(gammas, axis=0, return_inverse=True)
        sols = np.stack([self.decode_one(g) for g in uniq])
        return sols[inv.reshape(-1)]

    # -- vertex path ---------------------------------------------------------
    def _decode_batch_vertices(self, gammas: np.ndarray) -> np.ndarray:
        V = self.vertices                       # [M, n]
        vals = gammas @ V.T                     # [B, M]
        best = vals.min(axis=1, keepdims=True)
        scale = np.maximum(np.abs(best), 1.0)
        on_face = vals <= best + 1e-9 * scale   # minimizing vertices
        w = on_face.astype(np.float64)
        centers = (w @ V) / w.sum(axis=1, keepdims=True)
        return pseudo_to_cw(centers, self.allow_pseudo, eps=1e-4)

    def decode_batch(self, gammas: np.ndarray) -> np.ndarray:
        gammas = np.asarray(gammas, dtype=np.float64)
        if self.vertices is not None:
            return self._decode_batch_vertices(gammas)
        return self._decode_batch_linprog(gammas)
