"""BEC density evolution and irregular LDPC design (counterpart of
``ldpc_decoders_tpu.design.density_evolution``; host-side numpy and scipy,
the same values on the same seeds and the same files).

Capability parity with reference src/ldpc.py:
- DE recursion f(eps, x) = eps * lambda(1 - rho(1 - x)) (ldpc.py:24-25);
- BP threshold eps_BP by bisection (ldpc.py:103-112);
- optimal lambda(x) for a given rho(x) and channel eps via linear
  programming, with an outer bisection on eps to hit a target design rate
  (ldpc.py:40-94);
- node-perspective distributions L(x) = int(lambda)/int_0^1(lambda)
  (ldpc.py:128-135);
- irregular ensemble sampling by socket shuffling with double-edge
  removal (ldpc.py:149-192). Where the reference hardcodes an integer
  'extra' fixup (ldpc.py:158-173 "must be solved for, not hardcoded"),
  this implementation solves the rounding correction: top up to exactly
  num_var variables at degree 2, then bump single degrees until the
  socket count divides the check degree.

Polynomials follow numpy's convention (highest-order coefficient first),
like the reference.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Sequence

import numpy as np

log = logging.getLogger("design.de")


# ----------------------------------------------------------------------
# Polynomial helpers
# ----------------------------------------------------------------------

def reg_pol(deg: int) -> list:
    """x^deg (reference ldpc.py:117)."""
    return [1] + [0] * deg


def poly_eval(p, x):
    return np.polyval(p, x)


def avg_deg_inv(p) -> float:
    """int_0^1 p(x) dx — the inverse average degree of an edge poly."""
    return float(np.polyval(np.polyint(p), 1.0))


def rate_from_polys(lambda_p, rho_p) -> float:
    """Design rate 1 - int(rho)/int(lambda) (reference ldpc.py:21)."""
    return 1.0 - avg_deg_inv(rho_p) / avg_deg_inv(lambda_p)


def get_node_dist(pol) -> np.ndarray:
    """Edge-perspective -> node-perspective distribution (ldpc.py:128-131)."""
    int_p = np.polyint(pol)
    return int_p / np.polyval(int_p, 1.0)


def pol2str(pol) -> str:
    return " + ".join(
        "%sx^%d" % ("%g " % pol[-i - 1] if pol[-i - 1] != 1.0 else "", i)
        for i in range(len(pol)) if pol[-i - 1] != 0.0)


# ----------------------------------------------------------------------
# Density evolution
# ----------------------------------------------------------------------

def de_step(eps: float, lambda_p, rho_p, x):
    """One BEC DE update: eps * lambda(1 - rho(1 - x)) (ldpc.py:24-25)."""
    return eps * poly_eval(lambda_p, 1.0 - poly_eval(rho_p, 1.0 - x))


def solve_eps_bp(lambda_p, rho_p, tolerance: float = 1e-8,
                 grid: int = 500) -> float:
    """BP threshold: largest eps with eps*lambda(1-rho(1-x)) <= x on (0,1]
    — bisection on the max DE-step gap (reference ldpc.py:103-112)."""
    xs = np.linspace(1e-3, 1.0, num=grid)
    lo, hi = 0.0, 1.0
    while hi - lo > tolerance:
        eps = (lo + hi) / 2.0
        gap = float(np.max(de_step(eps, lambda_p, rho_p, xs) - xs))
        if gap > 0:
            hi = eps
        else:
            lo = eps
    return (lo + hi) / 2.0


@dataclasses.dataclass
class Dist:
    """An irregular ensemble: edge polynomials + BP threshold
    (reference ldpc.py:12-16)."""
    name: str
    lambda_p: Sequence[float]
    rho_p: Sequence[float]
    thresh: float

    @property
    def rate(self) -> float:
        return rate_from_polys(self.lambda_p, self.rho_p)


class LambdaSolver:
    """Maximize the design rate over lambda for fixed rho and channel eps:
    maximize sum lambda_i / i subject to the DE constraint
    eps * lambda(1 - rho(1 - x)) <= x on a grid (reference ldpc.py:30-79)."""

    def __init__(self, l_max: int, rho_p, discrete_count: int = 100,
                 tolerance: float = 1e-8):
        self.rho_p = rho_p
        self.tolerance = tolerance
        degs = np.arange(2, l_max + 1)
        self.degs = degs
        self.c_obj = -1.0 / degs
        xd = np.linspace(0.0, 1.0, num=discrete_count)
        rho1 = poly_eval(rho_p, 1.0 - xd)
        self.a_ub = (1.0 - rho1)[:, None] ** (degs - 1)
        self.b_ub = xd

    def solve(self, eps: float) -> list:
        from scipy.optimize import linprog

        res = linprog(self.c_obj, A_ub=eps * self.a_ub, b_ub=self.b_ub,
                      A_eq=np.ones((1, self.degs.size)), b_eq=[1.0],
                      bounds=(0, None), method="highs")
        if not res.success:
            raise RuntimeError(f"lambda LP failed at eps={eps}: {res.message}")
        # numpy convention: highest order first; lambda_1 = 0.
        return list(np.flip(res.x)) + [0.0]

    def solve_for_rate(self, target_rate: float,
                       interval=(0.0, 1.0)) -> tuple:
        """Bisect eps until the rate-optimal lambda hits the target rate
        (reference ldpc.py:67-79). Returns (lambda_p, eps_BP)."""
        lo, hi = interval
        lambda_p = None
        for _ in range(200):
            eps = (lo + hi) / 2.0
            lambda_p = self.solve(eps)
            actual = rate_from_polys(lambda_p, self.rho_p)
            log.debug("eps=%g actual_rate=%g", eps, actual)
            if abs(actual - target_rate) < self.tolerance:
                break
            if actual > target_rate:
                lo = eps
            else:
                hi = eps
        return lambda_p, eps


def solve_dist(name: str, target_rate: float, rho_p, l_max: int = 40,
               tol_l_max: float = 1e-5, tol_iter: float = 1e-8,
               discrete_count: int = 100) -> Dist:
    """Optimal lambda + eps_BP for a target rate (reference ldpc.py:83-94)."""
    lambda_p, eps_bp = LambdaSolver(
        l_max, rho_p, discrete_count, tol_iter).solve_for_rate(target_rate)
    while lambda_p and lambda_p[0] < tol_l_max:
        lambda_p.pop(0)
    return Dist(name, lambda_p, rho_p, eps_bp)


# ----------------------------------------------------------------------
# Irregular ensemble sampling
# ----------------------------------------------------------------------

def _node_degree_counts(L_p, num_var: int, chk_deg: int) -> np.ndarray:
    """Integer node counts per variable degree from L(x), corrected so
    counts sum to num_var and total sockets divide chk_deg."""
    # L_p numpy convention: L_p[-d-1] is the fraction of degree-d nodes.
    max_deg = len(L_p) - 1
    counts = np.zeros(max_deg + 1, dtype=np.int64)  # index = degree
    for d in range(1, max_deg + 1):
        counts[d] = int(L_p[-d - 1] * num_var)
    # Top up the rounding deficit with degree-2 nodes (the most common).
    deficit = num_var - int(counts.sum())
    if deficit < 0:
        raise ValueError("rounding produced too many variables")
    counts[2] += deficit
    # Bump degrees 2->3 one node at a time until sockets % chk_deg == 0.
    sockets = int((np.arange(counts.size) * counts).sum())
    bumps = (-sockets) % chk_deg
    if bumps > counts[2]:
        raise ValueError("cannot fix socket parity with degree bumps")
    if bumps and counts.size <= 3:
        # No degree-3 bucket exists: moving bumps 2->2 would leave total
        # sockets unchanged and the divisibility assert downstream would
        # fail opaquely. Fail here with the actual cause instead.
        raise ValueError(
            "cannot fix socket parity: max variable degree is 2, so there "
            "is no degree-3 bucket to bump into")
    counts[2] -= bumps
    counts[3] += bumps
    return counts


def sample_irregular_parity(rng: np.random.Generator, dist: Dist,
                            num_var: int) -> np.ndarray:
    """One H sample: shuffle variable sockets against regular check
    sockets; double edges cancel mod 2 (reference ldpc.py:184-189)."""
    chk_deg = len(dist.rho_p)  # rho = x^r -> check degree r+1
    L_p = get_node_dist(dist.lambda_p)
    counts = _node_degree_counts(L_p, num_var, chk_deg)

    # Variable i of degree d contributes d sockets.
    degrees = np.repeat(np.arange(counts.size), counts)  # degree per var
    rng.shuffle(degrees)
    var_sockets = np.repeat(np.arange(num_var), degrees)
    assert var_sockets.size % chk_deg == 0
    num_chk = var_sockets.size // chk_deg

    rng.shuffle(var_sockets)
    H = np.zeros((num_chk, num_var), dtype=np.int64)
    chk_of_socket = np.repeat(np.arange(num_chk), chk_deg)
    np.add.at(H, (chk_of_socket, var_sockets), 1)
    H %= 2  # double edges cancel (reference ldpc.py:189)
    return H


def gen_rand_irg_ldpc(count: int, num_var: int, rho_r: int, rate: float,
                      seed=None, dir_path=None) -> List[str]:
    """Generate `count` irregular codes named
    <n>_rho_x<r>_rand_ldpc_<i> (reference ldpc.py:149-192)."""
    from ldpc_decoders_tpu_torch.codes.code import save_parity_mtx

    dist = solve_dist(f"rho_r={rho_r}", rate, reg_pol(rho_r))
    rng = np.random.default_rng(seed)
    names = []
    for i in range(count):
        H = sample_irregular_parity(rng, dist, num_var)
        name = f"{num_var}_rho_x{rho_r}_rand_ldpc_{i + 1}"
        save_parity_mtx(H, name, dir_path)
        names.append(name)
    return names


# ----------------------------------------------------------------------
# CLI (reference ldpc.py:225-245)
# ----------------------------------------------------------------------

def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="density evolution / design")
    p.add_argument("task", choices=["plt", "irg"])
    p.add_argument("--count", type=int, default=10)
    p.add_argument("--len", type=int, default=1200)
    p.add_argument("--rate", type=float, default=0.5)
    p.add_argument("--rho", type=int, default=5)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--out", type=str, default=None,
                   help="codes dir (irg) / plot path (plt)")
    args = p.parse_args(argv)

    if args.task == "irg":
        for name in gen_rand_irg_ldpc(args.count, args.len, args.rho,
                                      args.rate, args.seed, args.out):
            print(name)
    else:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        xs = np.linspace(0, 0.6, num=200)
        for rho_r in (6, 5, 4):
            d = solve_dist(f"rho_r={rho_r}", args.rate, reg_pol(rho_r))
            plt.plot(xs, de_step(d.thresh, d.lambda_p, d.rho_p, xs),
                     linewidth=3,
                     label=f"{d.name}: rate={d.rate:.3f}, "
                           f"eps_BP={d.thresh:.4f}")
        plt.plot(xs, xs, "k--", linewidth=2)
        plt.title("Density Evolution for BEC")
        plt.xlabel("$x_l$"), plt.ylabel("$x_{l+1}$")
        plt.legend(loc="best"), plt.grid(True)
        out = args.out or "de_plot.png"
        plt.savefig(out, dpi=120)
        print(out)


if __name__ == "__main__":
    main()
