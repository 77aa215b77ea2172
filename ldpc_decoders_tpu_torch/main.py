"""Command-line entry point: ``python -m ldpc_decoders_tpu_torch.main <channel> <code> <decoder>``.

The JAX package's argv contract, ADMMA's ``--layers``, ``--train``,
``--apprx`` and ``--cache_dir`` included, plus ``--device`` (default
``cuda``). ``--kernel`` is accepted; set to anything but its default it
stops with an error that names its ROADMAP item.

``--mesh N`` shards each chunk's batch over N ranks, ``--mesh-code N``
shards the parity checks over N ranks (``EdgeShardedBPDecoder``, SPA and
MSA on the BSC and biAWGN), and both together make an ``[M, N]`` batch x
code mesh. Without a process group the CLI spawns the ranks on this host,
one process each (``parallel.mesh.run_ranks``); under ``torchrun`` (or
after ``initialize_distributed``) the world's ranks are the mesh. On cards
each rank takes its own card over NCCL; ``--dist-backend gloo`` lets ranks
share cards.

``--plots_dir`` is accepted and unused, as in the JAX CLI (the plots are
``viz.graph`` and ``viz.cases``). ``--bf16`` selects the bf16-message kernel; without it the f32 kernel runs (nothing
is downgraded silently, unlike the JAX harness, which moves f32 biAWGN BP
to its bf16 kernel).
``--presort`` is accepted for argv compatibility and has no effect: it
aligns the JAX ADMM kernel's per-block exit with per-word cost, and the
CUDA kernel's exit is per word. ``--iter-cap`` bounds a run to convergence
(``--max-iter <= 0``), as ``RunConfig.iter_cap`` does in the JAX package.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from ldpc_decoders_tpu_torch.channels import CHANNELS, DECODER_NAMES
from ldpc_decoders_tpu_torch.codes import get_code_names
from ldpc_decoders_tpu_torch.harness import MonteCarloRunner, RunConfig
from ldpc_decoders_tpu_torch.parallel.mesh import (
    BACKENDS,
    batch_mesh,
    code_mesh,
    is_coordinator,
    run_ranks,
)
from ldpc_decoders_tpu_torch.utils.file import make_dir_if_not_exists, resolve_data_dir_os

# Flags of the JAX CLI whose features are not ported -> ROADMAP item.
_NOT_PORTED = {
    "--kernel": "A.4 (the port has one route per device)",
}


def bind_parser_common(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Common output/logging flags."""
    base = resolve_data_dir_os("decoders")
    path_ = lambda p: os.path.abspath(os.path.join(base, p))  # noqa: E731
    parser.add_argument("--data_dir", default=path_("data"),
                        help="location for writing simulation output")
    parser.add_argument("--cache_dir", default=path_("cache"),
                        help="cache directory for ADMMA checkpoints")
    parser.add_argument("--plots_dir", default=path_("plots"),
                        help="save location of plots")
    parser.add_argument("--debug", action="store_true", help="log debug info")
    parser.add_argument("--console", action="store_true",
                        help="log to console instead of <data_dir>/test.log")
    return parser


def setup_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="LDPC Monte-Carlo channel simulation (PyTorch / CUDA)")
    parser.add_argument("channel", choices=sorted(CHANNELS))
    parser.add_argument("code", choices=get_code_names(),
                        help="code name (set FILE_CODES_DIR for file codes)")
    parser.add_argument("decoder", choices=DECODER_NAMES)

    parser.add_argument("--codeword", type=int, default=0, choices=[-1, 0, 1],
                        help="transmitted codeword: 0 all-zero, 1 all-ones, "
                             "-1 random codebook row (small codes only)")
    parser.add_argument("--min-wec", type=int, default=100,
                        help="min word errors to accumulate per sweep point")
    parser.add_argument("--params", nargs="+", type=float, default=[.1, .01],
                        help="channel parameter sweep values")
    parser.add_argument("--max-iter", type=int, default=10,
                        help="max iterations (<=0: run to convergence)")
    parser.add_argument("--iter-cap", type=int, default=2000,
                        help="safety bound on a run to convergence")
    parser.add_argument("--mu", type=float, default=3.0, help="ADMM mu")
    parser.add_argument("--eps", type=float, default=1e-5, help="ADMM eps")
    parser.add_argument("--allow-pseudo", action="store_true",
                        help="keep fractional pseudo-codewords (LP/ADMM)")
    parser.add_argument("--layers", nargs="+", type=int, default=[100, 100],
                        help="ADMMA MLP hidden layers")
    parser.add_argument("--train", action="store_true",
                        help="train ADMMA online against the exact projection")
    parser.add_argument("--apprx", type=int, default=-1,
                        help="ADMMA: iterations using the approximate "
                             "projection before switching to exact")
    parser.add_argument("--log-freq", type=float, default=5.0,
                        help="status log cadence, seconds")
    parser.add_argument("--batch", type=int, default=4096,
                        help="codewords per chunk")
    parser.add_argument("--seed", type=int, default=0, help="PRNG seed")
    parser.add_argument("--mesh", type=int, default=0,
                        help="shard the batch over N ranks, one process "
                             "(and one card) each (0 = one process)")
    parser.add_argument("--mesh-code", type=int, default=0,
                        help="shard parity checks over N ranks "
                             "(EdgeShardedBPDecoder: SPA/MSA on bsc and "
                             "biawgn); with --mesh M an M x N batch x code "
                             "mesh")
    parser.add_argument("--dist-backend", choices=BACKENDS, default=None,
                        help="process-group backend of a mesh: nccl (one "
                             "card per rank, the default on cuda) or gloo "
                             "(the CPU's; on cuda it lets ranks share cards)")
    parser.add_argument("--max-words", type=int, default=None,
                        help="safety cap on words per sweep point")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 BP messages (the bf16 kernel); "
                             "without it the float32 kernel runs (the "
                             "erasure decoder has integer messages)")
    parser.add_argument("--inf-policy", choices=["reference", "saturate"],
                        default="reference",
                        help="SPA inf semantics: the reference's float64 "
                             "inf/NaN cascade, or clean saturation")
    parser.add_argument("--kernel", choices=["auto", "xla", "pallas"],
                        default="auto",
                        help="JAX compute route (not ported: the port runs "
                             "the CUDA kernel on cuda, plain PyTorch on cpu)")
    parser.add_argument("--pipeline", type=int, default=4,
                        help="chunks in flight ahead of the host sync")
    parser.add_argument("--fixed-pipeline", action="store_true",
                        help="disable the adaptive pipeline fill")
    parser.add_argument("--profile", action="store_true",
                        help="log per-section LoopProfiler timings")
    parser.add_argument("--presort", choices=["auto", "on", "off"],
                        default="auto",
                        help="the JAX ADMM kernel's probe-and-sort; accepted "
                             "and without effect (the CUDA kernel exits per "
                             "word)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (the CUDA kernel) or cpu "
                             "(the plain PyTorch version)")
    return bind_parser_common(parser)


def parse_args(argv=None) -> argparse.Namespace:
    parser = setup_parser()
    args = parser.parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        dest = flag[2:].replace("-", "_")
        if getattr(args, dest) != parser.get_default(dest):
            parser.error(f"{flag} is not ported yet (ROADMAP {item})")
    if args.mesh < 0 or args.mesh_code < 0:
        parser.error("--mesh and --mesh-code count ranks (0 = unsharded)")
    if args.mesh_code and (args.decoder not in ("SPA", "MSA")
                           or args.channel == "bec"):
        parser.error("--mesh-code shards the LLR-domain BP decoders (SPA, "
                     "MSA on bsc and biawgn) only")
    if args.mesh and args.batch % args.mesh:
        parser.error(f"--batch {args.batch} does not divide over --mesh "
                     f"{args.mesh} ranks")
    if args.dist_backend == "nccl" and args.device == "cpu":
        parser.error("--dist-backend nccl needs --device cuda")
    return args


def mesh_ranks(args: argparse.Namespace) -> int:
    """The ranks a parsed command line asks for."""
    return max(args.mesh, 1) * max(args.mesh_code, 1)


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    spawned, res = run_ranks("ldpc_decoders_tpu_torch.main:main", argv,
                             mesh_ranks(args), args.device, args.dist_backend)
    if spawned:
        return res          # rank 0's results are the run's
    level = logging.DEBUG if args.debug else logging.INFO
    if args.console:
        logging.basicConfig(format="%(name)s|%(message)s", level=level)
    else:
        make_dir_if_not_exists(args.data_dir)
        logging.basicConfig(
            filename=os.path.join(args.data_dir, "test.log"), filemode="a",
            format="%(asctime)s,%(msecs)03d|%(name)s|%(levelname)s|%(message)s",
            datefmt="%H:%M:%S", level=level)

    cfg = RunConfig(
        channel=args.channel, code=args.code, decoder=args.decoder,
        params=args.params, codeword=args.codeword, min_wec=args.min_wec,
        max_iter=args.max_iter, mu=args.mu, eps=args.eps,
        allow_pseudo=args.allow_pseudo, layers=args.layers, train=args.train,
        apprx=args.apprx, iter_cap=args.iter_cap,
        batch=args.batch, seed=args.seed,
        log_freq=args.log_freq, max_words=args.max_words,
        data_dir=args.data_dir, cache_dir=args.cache_dir,
        profile=args.profile,
        msg_dtype="bfloat16" if args.bf16 else "float32",
        inf_policy=args.inf_policy,
        pipeline=args.pipeline, adaptive_pipeline=not args.fixed_pipeline,
        device=args.device)
    mesh = None
    if args.mesh_code:
        mesh = code_mesh(args.mesh_code, args.mesh)
    elif args.mesh:
        mesh = batch_mesh(args.mesh)
    if is_coordinator():
        print(vars(args))
    return MonteCarloRunner(cfg, mesh=mesh).run()


if __name__ == "__main__":
    main()
