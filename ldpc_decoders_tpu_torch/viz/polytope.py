"""Parity-polytope projection demos in 2D and 3D (counterpart of
``ldpc_decoders_tpu.viz.polytope``): random points and their projections
onto PP_2 (a segment) and PP_3 (a tetrahedron), drawn to files. The
projections are the port's ``project_rows``: on the card (the default) the
projection kernel of ``csrc/admm_step.cu``, on the CPU, where the caller
asks for it, the plain ``project_parity_polytope``.

Usage:
    python -m ldpc_decoders_tpu_torch.viz.polytope 3 --points 60 \\
        --out polytope_3d.png [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ldpc_decoders_tpu_torch.ops.admm_step import project_rows

# Spread of the demo points around 0.5, per dimension (the JAX package's).
_SIGMA = {2: 0.8, 3: 0.7}


def _plt(agg=True):
    import matplotlib
    if agg:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def demo_points(dim: int, n_points: int, seed: int = 0,
                device="cuda") -> tuple:
    """(v, z): ``n_points`` float32 points of N(0.5, sigma^2) in ``dim``
    dimensions from ``default_rng(seed)``, and their projections computed
    on ``device``; both numpy [n_points, dim]."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0.5, _SIGMA[dim], (n_points, dim)).astype(np.float32)
    z = project_rows(torch.as_tensor(v, device=device))
    return v, z.cpu().numpy()


def demo_2d(n_points: int = 40, seed: int = 0, out: str = "polytope_2d.png",
            device="cuda"):
    """PP_2 = conv{(0,0), (1,1)}: a segment; points project onto it."""
    v, z = demo_points(2, n_points, seed, device)
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot([0, 1], [0, 1], "k-", linewidth=3, label="PP$_2$")
    ax.scatter(v[:, 0], v[:, 1], c="tab:red", s=18, label="inputs")
    ax.scatter(z[:, 0], z[:, 1], c="tab:blue", s=18, label="projections")
    for a, b in zip(v, z):
        ax.plot([a[0], b[0]], [a[1], b[1]], "gray", linewidth=0.6)
    ax.set_aspect("equal"), ax.legend(), ax.grid(True)
    ax.set_title("Euclidean projection onto the parity polytope, d=2")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def demo_3d(n_points: int = 60, seed: int = 0, out: str = "polytope_3d.png",
            device="cuda"):
    """PP_3 = conv{000, 011, 101, 110}: a tetrahedron."""
    v, z = demo_points(3, n_points, seed, device)
    plt = _plt()
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    verts = np.array([[0, 0, 0], [0, 1, 1], [1, 0, 1], [1, 1, 0]], float)
    for i in range(4):
        for j in range(i + 1, 4):
            ax.plot(*zip(verts[i], verts[j]), "k-", linewidth=1.5)
    ax.scatter(*v.T, c="tab:red", s=14, label="inputs")
    ax.scatter(*z.T, c="tab:blue", s=14, label="projections")
    for a, b in zip(v, z):
        ax.plot(*zip(a, b), color="gray", linewidth=0.5)
    ax.legend()
    ax.set_title("Euclidean projection onto the parity polytope, d=3")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="parity polytope demos")
    p.add_argument("dim", type=int, choices=[2, 3])
    p.add_argument("--out", default=None)
    p.add_argument("--points", type=int, default=40)
    p.add_argument("--device", default="cuda",
                   help="torch device of the projections: cuda or cpu")
    args = p.parse_args(argv)
    fn = demo_2d if args.dim == 2 else demo_3d
    print(fn(n_points=args.points,
             out=args.out or f"polytope_{args.dim}d.png",
             device=args.device))


if __name__ == "__main__":
    main()
