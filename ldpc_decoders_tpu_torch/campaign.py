"""Experiment campaigns (counterpart of ``ldpc_decoders_tpu.campaign``):
the reference's shell-level orchestration as a case registry.

A campaign is an ordered list of RunConfigs executed in-process on one
device. ``--emit`` prints the equivalent CLI lines instead of running (the
reference's print-then-eval contract for external schedulers): the same
lines the JAX package prints.

Case registry: HMG, MAR, REG_BAD, REG_ENS, IREG_ENS. What runs:

- plain cases run each RunConfig through ``MonteCarloRunner``;
- REG_BAD's iteration-cap grid runs as five ``CapSweepRunner`` passes, one
  per leg, every cap tallied from one decode;
- REG_ENS / IREG_ENS run each of their five legs over the ten member
  codes: by default through one runner rotated from member to member
  (``run_rotating_members``, member ``i`` seeded ``seed + i``), with
  ``--joint-ensemble`` through ``EnsembleMonteCarloRunner`` (every member in
  each chunk, batch 2048 per member); IREG_ENS at cap 100
  (``ENSEMBLE_MAX_ITER``), REG_ENS at 10. ``--no-ensemble`` runs the
  per-member RunConfigs one by one;
- HMG (ML, LP, SPA, MSA, ADMM on Hamming(7,4)) and MAR (ADMM and the five
  BP legs on margulis) run whole.

``mesh`` (``--mesh N`` on the CLI, which spawns the ranks as ``main``
does) goes to the plain, rotating and joint runners, as the JAX function
passes it, and to the cap sweeps, which the JAX function runs on one
device: here they fan out over the ranks as the other runners do.

Precision is explicit. The JAX harness moves a float32 biAWGN BP run to
its bf16 kernel on a chip and keeps the BSC in float32; the port's
runners never change the message type behind the caller's back, so
``run_campaign`` itself sets ``msg_dtype="bfloat16"`` on biAWGN legs and
``"float32"`` on BSC legs (whose LLRs are equal multiples of one value: a
tie structure that is not bf16-safe). The erasure decoder's integer
messages have no message type.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Iterator, List

from ldpc_decoders_tpu_torch.harness import (
    CapSweepRunner,
    MonteCarloRunner,
    RunConfig,
    run_rotating_members,
)
from ldpc_decoders_tpu_torch.harness.ensemble_runner import (
    EnsembleMonteCarloRunner,
)
from ldpc_decoders_tpu_torch.parallel.mesh import (
    BACKENDS,
    batch_mesh,
    run_ranks,
)
from ldpc_decoders_tpu_torch.utils.registry import Registry

all_cases = Registry()
reg_case = all_cases.reg

def stp(init: float, step: float, count: int) -> List[float]:
    return [init + i * step for i in range(count)]


# Default per-code sweeps (reference simulations.py:27-39).
_BEC_DEF = [.5, .475, .45, .425, .4, .375, .35, .34, .33, .325, .32, .31, .3]
_BSC_MSA = [.081, .0751, .071, .0651, .061, .0551, .051, .0451, .041,
            .0351, .031, .0251, .021, .0151, .01]
_AWGN_MSA = [.5, .75, 1., 1.25, 1.5, 1.75, 2., 2.2, 2.3, 2.4, 2.5, 2.6,
             2.7, 2.8, 2.9, 3.0]
_AWGN_SPA = [.5, .75, 1., 1.25, 1.5, 1.75, 2., 2.25, 2.5, 2.75, 3.]


def def_cases(code: str, mi: int = 10, mw: int = 100) -> Iterator[RunConfig]:
    yield RunConfig("bec", code, "SPA", _BEC_DEF, codeword=0, max_iter=mi,
                    min_wec=mw)
    yield RunConfig("bsc", code, "MSA", _BSC_MSA, codeword=1, max_iter=mi,
                    min_wec=mw)
    yield RunConfig("biawgn", code, "MSA", _AWGN_MSA, codeword=1,
                    max_iter=mi, min_wec=mw)
    yield RunConfig("bsc", code, "SPA", stp(.1, -.01, 7), codeword=0,
                    max_iter=mi, min_wec=mw)
    yield RunConfig("biawgn", code, "SPA", _AWGN_SPA, codeword=0,
                    max_iter=mi, min_wec=mw)


@reg_case
def HMG() -> Iterator[RunConfig]:
    """All Hamming(7,4) sims (reference simulations.py:49-61)."""
    p_bec = [.5, .4, .3, .2, .1, .08, .06, .04, .02]
    p_bsc = p_bec + [.25, .15, .01, .008, .006, .004, .002]
    p_awgn = stp(2, .5, 11)
    code = "7_4_hamming"
    kw = dict(codeword=1, min_wec=300)
    for dec in ["ML", "LP", "SPA", "ADMM"]:
        yield RunConfig("bec", code, dec, p_bec, **kw)
    for dec in ["ML", "LP", "SPA", "MSA", "ADMM"]:
        yield RunConfig("bsc", code, dec, p_bsc, **kw)
    for dec in ["ML", "LP", "SPA", "MSA", "ADMM"]:
        yield RunConfig("biawgn", code, dec, p_awgn, **kw)


@reg_case
def MAR() -> Iterator[RunConfig]:
    """Margulis(2640,1320) ADMM sims (reference simulations.py:63-72)."""
    code = "margulis"
    kw = dict(codeword=1, min_wec=100)
    yield RunConfig("bec", code, "ADMM", _BEC_DEF, **kw)
    yield RunConfig("bsc", code, "ADMM", [.1, .09, .08, .07, .06, .05, .04],
                    **kw)
    yield RunConfig("biawgn", code, "ADMM", _AWGN_SPA, **kw)
    yield from def_cases(code)


@reg_case
def REG_BAD() -> Iterator[RunConfig]:
    """Max-iter sweep on LDPC(1200,3,6) (reference simulations.py:74-77)."""
    yield from def_cases("1200_3_6_ldpc")
    for mi in [0, 1, 2, 3, 6, 40, 100]:
        yield from def_cases("1200_3_6_ldpc", mi)


# Ensemble campaigns: ten member codes per config, run by the ensemble
# routes of run_campaign. The generators below are the --emit contract and
# the --no-ensemble path.
ENSEMBLE_MEMBERS = {
    "REG_ENS": [f"1200_3_6_rand_ldpc_{i + 1}" for i in range(10)],
    "IREG_ENS": [f"1200_rho_x5_rand_ldpc_{i + 1}" for i in range(10)],
}

# The committed IREG goldens are cap-100 vintage; REG_ENS goldens are
# cap 10 (the def_cases default).
ENSEMBLE_MAX_ITER = {"IREG_ENS": 100}

# REG_BAD's iteration-cap grid collapses: CapSweepRunner tallies every cap
# from one decode pass, so the 8-cap x 5-sweep grid is 5 runs, not 40.
CAP_SWEEP_CASES = {
    "REG_BAD": ("1200_3_6_ldpc", [0, 1, 2, 3, 6, 10, 40, 100]),
}


@reg_case
def REG_ENS() -> Iterator[RunConfig]:
    for name in ENSEMBLE_MEMBERS["REG_ENS"]:
        yield from def_cases(name)


@reg_case
def IREG_ENS() -> Iterator[RunConfig]:
    for name in ENSEMBLE_MEMBERS["IREG_ENS"]:
        yield from def_cases(name, ENSEMBLE_MAX_ITER["IREG_ENS"])


# ----------------------------------------------------------------------
# Execution
# ----------------------------------------------------------------------

def to_argv(cfg: RunConfig) -> str:
    """Equivalent ``python -m ldpc_decoders_tpu_torch.main`` line (the
    reference's simulations.py print contract, for external schedulers)."""
    parts = [cfg.channel, cfg.code, cfg.decoder,
             "--codeword=%d" % cfg.codeword,
             "--max-iter=%d" % cfg.max_iter,
             "--min-wec=%d" % cfg.min_wec,
             "--params " + " ".join("%g" % p for p in cfg.params)]
    return " ".join(parts)


def _plan(case_names, use_ensemble: bool,
          joint_ensemble: bool = False) -> list:
    """The runs of the named cases as (case, kind, cfg, extra): extra is
    the cap labels of a "caps" run and the member codes of a "rotating" or
    "joint" ensemble run (whose cfg.code is the case's name, a label)."""
    plan = []
    for name in case_names:
        if use_ensemble and name in ENSEMBLE_MEMBERS:
            kind = "joint" if joint_ensemble else "rotating"
            mi = ENSEMBLE_MAX_ITER.get(name, 10)
            plan += [(name, kind, cfg, ENSEMBLE_MEMBERS[name])
                     for cfg in def_cases(name, mi)]
        elif use_ensemble and name in CAP_SWEEP_CASES:
            code, caps = CAP_SWEEP_CASES[name]
            plan += [(name, "caps", cfg, caps) for cfg in def_cases(code)]
        else:
            plan += [(name, "plain", cfg, None)
                     for cfg in all_cases.get(name)()]
    return plan


def run_campaign(case_names, data_dir=None, mesh=None, overrides=None,
                 use_ensemble=True, joint_ensemble=False,
                 device="cuda") -> dict:
    """Run the named cases on ``device``; returns {(case, argv): results},
    an ensemble run's results as {member: {param: metrics}}. biAWGN legs
    run bf16 messages and BSC legs float32 (module docstring); cap sweeps
    and joint ensemble runs go at batch 2048 as the JAX package has them.
    ``overrides`` (RunConfig fields) apply last; ``mesh`` shards every
    run's batch."""
    results = {}
    for name, kind, cfg, extra in _plan(case_names, use_ensemble,
                                        joint_ensemble):
        cfg = dataclasses.replace(
            cfg, device=device, data_dir=data_dir,
            msg_dtype="bfloat16" if cfg.channel == "biawgn" else "float32")
        if kind in ("caps", "joint"):
            cfg = dataclasses.replace(cfg, batch=2048)
        cfg = dataclasses.replace(cfg, **(overrides or {}))
        if kind == "caps":
            results[(name, f"caps:{to_argv(cfg)}")] = CapSweepRunner(
                cfg, extra, mesh=mesh).run()
        elif kind == "rotating":
            results[(name, f"rotating:{to_argv(cfg)}")] = \
                run_rotating_members(cfg, extra, mesh=mesh)
        elif kind == "joint":
            results[(name, f"ensemble:{to_argv(cfg)}")] = \
                EnsembleMonteCarloRunner(cfg, extra, mesh=mesh).run()
        else:
            results[(name, to_argv(cfg))] = MonteCarloRunner(
                cfg, mesh=mesh).run()
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="run experiment campaigns")
    p.add_argument("case", nargs="+", choices=all_cases.keys())
    p.add_argument("--emit", action="store_true",
                   help="print CLI lines instead of running")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--min-wec", dest="min_wec", type=int, default=None)
    p.add_argument("--no-ensemble", dest="no_ensemble", action="store_true",
                   help="run ensemble and cap-sweep cases one RunConfig at "
                        "a time (reference-style)")
    p.add_argument("--joint-ensemble", dest="joint_ensemble",
                   action="store_true",
                   help="decode every ensemble member in each chunk instead "
                        "of rotating one runner through the members")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the CUDA kernels) or cpu (the "
                        "plain PyTorch versions)")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard each run's batch over N ranks, one process "
                        "(and one card) each (0 = one process)")
    p.add_argument("--dist-backend", choices=BACKENDS, default=None,
                   help="process-group backend of a mesh: nccl (one card "
                        "per rank, the default on cuda) or gloo (the CPU's; "
                        "on cuda it lets ranks share cards)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    if args.mesh < 0:
        p.error("--mesh counts ranks (0 = one process)")
    if not args.emit:
        spawned, res = run_ranks("ldpc_decoders_tpu_torch.campaign:main",
                                 argv, args.mesh, args.device,
                                 args.dist_backend)
        if spawned:
            return res
    logging.basicConfig(format="%(name)s|%(message)s", level=logging.INFO)

    if args.emit:
        for name in args.case:
            for cfg in all_cases.get(name)():
                print(to_argv(cfg), flush=True)
        return None

    overrides = {}
    if args.batch:
        overrides["batch"] = args.batch
    if args.min_wec:
        overrides["min_wec"] = args.min_wec
    return run_campaign(args.case, data_dir=args.data_dir,
                        mesh=batch_mesh(args.mesh) if args.mesh else None,
                        overrides=overrides,
                        use_ensemble=not args.no_ensemble,
                        joint_ensemble=args.joint_ensemble,
                        device=args.device)


if __name__ == "__main__":
    main()
