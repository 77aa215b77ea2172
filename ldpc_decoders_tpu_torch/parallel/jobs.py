"""What a rank runs when tests, ``chip_smoke.py`` or a script spawn ranks
with :func:`~ldpc_decoders_tpu_torch.parallel.mesh.spawn` to hold a
multi-rank run against single-process replays: the spawned processes
import these functions by name, and they import nothing of JAX. The CLIs
do not use this module.

Each returns, beside its own output, the facts its caller holds a
multi-rank run to: the rank, whether it is the coordinator, whether
``jax`` got imported, and this rank's kernel launches.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ldpc_decoders_tpu_torch.parallel.mesh import (
    _resolve,
    batch_mesh,
    code_mesh,
    is_coordinator,
    world_rank,
    world_size,
)


def kernel_launches() -> dict:
    """This process's launch counts of every kernel wrapper."""
    from ldpc_decoders_tpu_torch.ops import (
        admm_kernel,
        admm_step,
        bec_kernel,
        chunk_kernel,
        lt_kernel,
        mlp_kernel,
        msa_kernel,
        spa_kernel,
    )

    msa, spa = msa_kernel.msa_decode_cuda, spa_kernel.spa_decode_cuda
    bec = bec_kernel.bec_spa_decode_cuda
    return {"msa_decode": msa.launches,
            "msa_decode_caps": msa.launches_caps,
            "spa_decode": spa.launches["saturate"],
            "spa_decode_caps": spa.launches_caps["saturate"],
            "spa_ref_decode": spa.launches["reference"],
            "spa_ref_decode_caps": spa.launches_caps["reference"],
            "bec_decode": bec.launches,
            "bec_decode_caps": bec.launches_caps,
            "admm_decode": admm_kernel.admm_decode_cuda.launches,
            "lt_peel": lt_kernel.lt_peel_cuda.launches,
            "admm_iter_pre": admm_step.admm_iter_pre_cuda.launches,
            "project_rows": admm_step.project_rows_cuda.launches,
            "admm_iter_post": admm_step.admm_iter_post_cuda.launches,
            "mlp_forward": mlp_kernel.mlp_forward_cuda.launches,
            "mlp_train": mlp_kernel.mlp_train_cuda.launches,
            "transmit": chunk_kernel.transmit_cuda.launches,
            "tally": chunk_kernel.tally_cuda.launches}


def _facts(out: dict, launches0: dict) -> dict:
    now = kernel_launches()
    out.update(rank=world_rank(), coordinator=is_coordinator(),
               jax="jax" in sys.modules,
               launches={k: now[k] - launches0[k] for k in now})
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def harness(cfg, kind: str = "plain", members=None, n_code: int = 0,
            caps=None, mesh=None) -> dict:
    """Run ``cfg`` on ``mesh``, by default a mesh of the world's ranks: a
    ``batch`` mesh, or with ``n_code`` a ``[world / n_code, n_code]``
    batch x code mesh (1-D where it is the whole world). ``kind``: "plain"
    (``MonteCarloRunner``), "rotating" (``run_rotating_members`` over
    ``members``), "joint" (``EnsembleMonteCarloRunner``) or "caps"
    (``CapSweepRunner`` over the cap labels ``caps``). Returns the results,
    the seconds the run took, where the tallies were summed
    (``device_tally``), for "plain" whether this rank built a Saver and,
    for ADMMA, the MLP's parameters after it."""
    from ldpc_decoders_tpu_torch.harness import (
        MonteCarloRunner,
        run_rotating_members,
    )
    from ldpc_decoders_tpu_torch.harness.cap_sweep import CapSweepRunner
    from ldpc_decoders_tpu_torch.harness.ensemble_runner import (
        EnsembleMonteCarloRunner,
    )

    launches0 = kernel_launches()
    if mesh is None:
        mesh = (code_mesh(n_code, world_size() // n_code) if n_code
                else batch_mesh())
    out = {"device_tally": mesh.device_tally}
    t0 = time.perf_counter()
    if kind == "plain":
        runner = MonteCarloRunner(cfg, mesh=mesh)
        out["results"] = runner.run()
        out["saver"] = runner.saver is not None
        mlp = getattr(getattr(runner.dec, "dec", None), "mlp", None)
        if mlp is not None:
            out["mlp"] = {k: v.detach().cpu().numpy()
                          for k, v in mlp.state_dict().items()}
    elif kind == "rotating":
        out["results"] = run_rotating_members(cfg, members, mesh=mesh)
    elif kind == "joint":
        out["results"] = EnsembleMonteCarloRunner(cfg, members,
                                                  mesh=mesh).run()
    elif kind == "caps":
        out["results"] = CapSweepRunner(cfg, caps, mesh=mesh).run()
    else:
        raise ValueError(f"unknown run kind {kind!r}")
    _sync(cfg.device)
    out["seconds"] = time.perf_counter() - t0
    return _facts(out, launches0)


def make_llr(code: str, channel: str, param: float, words: int, seed: int,
             device="cpu", codeword: int = 0) -> torch.Tensor:
    """LLRs of ``words`` copies of codeword ``codeword`` (0 or 1) of
    ``code`` sent through ``channel`` at ``param``, from a generator
    seeded ``seed`` on ``device``: the same tensor in every process that
    asks on the same kind of device (C1, ``ops/chunk_kernel.py``, on a
    card)."""
    from ldpc_decoders_tpu_torch.channels import CHANNELS
    from ldpc_decoders_tpu_torch.codes import get_code
    from ldpc_decoders_tpu_torch.ops import chunk_kernel

    gen = torch.Generator(device=device).manual_seed(int(seed))
    noise = CHANNELS[channel].draw((words, get_code(code).get_n()), gen,
                                   device)
    return chunk_kernel.transmit(channel, noise, param, codeword)


def edge_decode(code: str, variant: str, llr, device="cpu", **kw) -> dict:
    """``EdgeShardedBPDecoder`` over a ``code`` mesh of the world's ranks:
    x_hat and iters (numpy) on ``llr`` (an array, or the keyword arguments
    of :func:`make_llr`), and the decode's milliseconds (host clock around
    a synchronized call, after one warm-up call)."""
    from ldpc_decoders_tpu_torch.codes import get_code
    from ldpc_decoders_tpu_torch.parallel.bp_edge_sharded import (
        EdgeShardedBPDecoder,
    )

    launches0 = kernel_launches()
    dec = EdgeShardedBPDecoder(get_code(code).parity_mtx,
                               code_mesh(world_size()), variant,
                               device=device, **kw)
    x = (make_llr(code, device=device, **llr) if isinstance(llr, dict)
         else torch.from_numpy(np.asarray(llr, np.float32)).to(device))
    dec.decode(x)
    _sync(device)
    t0 = time.perf_counter()
    x_hat, iters = dec.decode(x)
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t0)
    return _facts({"x_hat": x_hat.cpu().numpy(),
                   "iters": iters.cpu().numpy(), "ms": ms}, launches0)


def cli(entry: str, argv) -> dict:
    """A CLI's ``main(argv)`` (``"module:function"``) under the spawned
    process group, whose ranks are its mesh; returns what it returns."""
    launches0 = kernel_launches()
    t0 = time.perf_counter()
    out = {"out": _resolve(entry)(list(argv))}
    out["seconds"] = time.perf_counter() - t0
    return _facts(out, launches0)


def lt_replay(k: int, n: int, c: float, delta: float, count: int,
              batch: int, seed: int = 0, done: int = 0,
              device="cpu") -> list:
    """This rank's LT stream replayed in this process alone, without a
    mesh: ``stream_batches`` of ``count`` sims in batches of ``batch`` from
    the rng the CLI gives this rank after ``done`` committed sims
    (``fountain.lt.rank_rng``); the batches' results as lists."""
    from ldpc_decoders_tpu_torch.fountain import lt

    sim = lt.LTSimulator(k, n, c, delta, device=device)
    rng = lt.rank_rng(seed, done, world_rank(), world_size())
    return [r.tolist() for r in lt.stream_batches(sim, rng, count, batch)]


def sequence(tasks) -> list:
    """Run ``tasks``, ``[(function, kwargs), ...]``, one after the other in
    the same ranks (one spawn for many checks); returns their outputs in
    order. A function is named by its name in this module, by
    ``"module:function"``, or given as a function the ranks can import."""
    return [_resolve(fn if callable(fn) or ":" in fn
                     else f"{__name__}:{fn}")(**kw) for fn, kw in tasks]
