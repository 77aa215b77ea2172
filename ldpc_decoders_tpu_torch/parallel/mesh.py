"""Ranks, meshes and the one-host launcher (counterpart of
``ldpc_decoders_tpu.parallel.mesh``).

The JAX package is one controller over N devices (``shard_map`` and
``psum``). The port runs one process per rank over ``torch.distributed``:

- ``initialize_distributed`` joins a process group (a no-op for fewer than
  two processes; under ``torchrun`` it reads the environment) and binds the
  rank to its card: rank r takes ``cuda:r`` (the local rank on a host). The
  backend is NCCL on cards and gloo on the CPU. NCCL refuses two ranks on
  one card, so ranks share a card only when the caller asks for gloo
  explicitly; a rank beyond the visible cards raises otherwise;
- ``spawn`` starts N ranks on this host (``torch.multiprocessing.spawn``,
  a ``file://`` store in a temporary directory, so concurrent runs never
  share a port) and returns each rank's return value, in rank order;
- ``batch_mesh`` / ``code_mesh`` describe the ranks as a row-major
  ``[batch, code]`` grid (rank = b * n_code + c, as
  ``np.array(devs).reshape(n_batch, n_code)`` lays out the JAX mesh), with
  a process group per axis. They hold exactly the world's ranks: a mesh of
  another size raises;
- ``local_batch`` is a rank's share of a global batch and raises where it
  does not divide;
- ``is_coordinator`` is rank 0, the only Saver writer;
- ``run_ranks`` is how the CLIs' ``--mesh`` reaches its ranks: it spawns
  them, or joins the world ``torchrun`` made.

A Monte-Carlo chunk's tally is a few integers. Over NCCL it is summed on
the card when the chunk is dispatched (``Mesh.device_tally``): the
collective is enqueued on the stream and the host does not wait for it.
Over gloo a collective on a card's tensor blocks the host, so there the
tally is summed on the host when the runner consumes the chunk
(``Mesh.host_sum``, after the copy the pipeline already waits for).
Measured on H100s (``PERF.md``), each design wins on its backend, so the
backend picks it. What must stay on the card (ADMMA's gradients, the
edge-sharded decoder's per-iteration sums) goes through the main group
(``Mesh.all_reduce``).
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import tempfile
from typing import Callable, Optional, Union

import torch
import torch.distributed as dist

AXES = ("batch", "code")
BACKENDS = ("nccl", "gloo")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """True on the process that owns result files and console output: rank
    0 (every rank holds the same summed tallies)."""
    return world_rank() == 0


def resolve_backend(device, backend: Optional[str] = None) -> str:
    """The backend for ranks on ``device``: NCCL on cards, gloo on the CPU,
    unless ``backend`` names one. NCCL needs cards."""
    kind = torch.device(device).type
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices; ranks on the "
                         "CPU use gloo")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (use --device cpu for the plain "
                           "PyTorch route)")
    return backend


def _check_cards(backend: str, ranks: int) -> None:
    have = torch.cuda.device_count()
    if backend == "nccl" and ranks > have:
        raise ValueError(
            f"need {ranks} devices for {ranks} NCCL ranks, have {have}: "
            "NCCL takes one card per rank (ranks share a card only over "
            "gloo, --dist-backend gloo)")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None, device="cuda",
                           init_method: Optional[str] = None,
                           timeout: Optional[float] = None) -> None:
    """Join the process group of ``num_processes`` ranks as ``process_id``
    (both from ``WORLD_SIZE`` / ``RANK`` when None, as ``torchrun`` sets
    them), rendezvous at ``coordinator_address`` ("host:port") or
    ``init_method`` (default ``env://``), and bind this rank to its card.
    A no-op for fewer than two processes."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    backend = resolve_backend(device, backend)
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        _check_cards(backend, local + 1)
        torch.cuda.set_device(local % torch.cuda.device_count())
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    kw = {"timeout": datetime.timedelta(seconds=timeout)} if timeout else {}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=num_processes, rank=process_id, **kw)


class Mesh:
    """The world's ranks as a row-major grid over ``shape``'s axes (some of
    ``("batch", "code")``, in that order), with this rank's coordinates and
    the process group of each axis it lies on: ``groups`` on the main
    backend, ``host_groups`` on gloo (the same groups where the main
    backend is gloo). ``device_tally`` says where the runners sum their
    chunk tallies: on the card over NCCL, on the host over gloo (module
    docstring). A one-rank mesh needs no process group and makes no
    collective."""

    def __init__(self, shape: dict):
        self.shape = {a: int(shape[a]) for a in AXES if a in shape}
        if set(shape) - set(AXES) or not self.shape:
            raise ValueError(f"mesh axes must be among {AXES}, got "
                             f"{list(shape)}")
        self.axis_names = tuple(self.shape)
        self.size = 1
        for n in self.shape.values():
            if n < 1:
                raise ValueError(f"mesh axes need at least one rank: "
                                 f"{self.shape}")
            self.size *= n
        world = world_size()
        if self.size != world:
            raise ValueError(
                f"need {self.size} ranks for a {self.shape} mesh, the world "
                f"has {world} (one process per rank: --mesh spawns them)")
        self.device_tally = world > 1 and dist.get_backend() == "nccl"
        n_code = self.width("code")
        self.rank = world_rank()
        self.coords = {"batch": self.rank // n_code,
                       "code": self.rank % n_code}
        self.groups, self.host_groups = {}, {}
        if world > 1:
            self._make_groups(n_code)

    def _make_groups(self, n_code: int) -> None:
        # Every rank creates every group, in the same order.
        gloo = dist.get_backend() == "gloo"
        n_batch = self.width("batch")
        lines = {"batch": [[b * n_code + c for b in range(n_batch)]
                           for c in range(n_code)],
                 "code": [[b * n_code + c for c in range(n_code)]
                          for b in range(n_batch)]}
        for axis in self.axis_names:
            for ranks in lines[axis]:
                main = dist.new_group(ranks)
                host = main if gloo else dist.new_group(ranks, backend="gloo")
                if self.rank in ranks:
                    self.groups[axis], self.host_groups[axis] = main, host

    def width(self, axis: str) -> int:
        """Ranks along ``axis`` (1 where the mesh has no such axis)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis] if axis in self.shape else 0

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` in place over ``axis`` through the main group."""
        if self.width(axis) > 1:
            dist.all_reduce(t, op=op, group=self.groups[axis])
        return t

    def all_true(self, flag: torch.Tensor, axis: str) -> bool:
        """Whether a boolean scalar is true on every rank along ``axis``."""
        t = flag.to(torch.int32).reshape(1)
        return bool(self.all_reduce(t, axis, dist.ReduceOp.MIN)[0])

    def host_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum a host tensor in place over ``axis`` through gloo."""
        if self.width(axis) > 1:
            dist.all_reduce(t, group=self.host_groups[axis])
        return t

    def host_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Every rank's host tensor of ``t``'s shape along ``axis``,
        concatenated in rank order, on every rank."""
        if self.width(axis) == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.width(axis))]
        dist.all_gather(parts, t, group=self.host_groups[axis])
        return torch.cat(parts)

    def host_broadcast(self, value: int) -> int:
        """Rank 0's ``value`` on every rank of a 1-D batch mesh."""
        if self.size == 1:
            return int(value)
        if self.axis_names != ("batch",):
            raise ValueError("host_broadcast needs a 1-D batch mesh")
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.broadcast(t, src=0, group=self.host_groups["batch"])
        return int(t[0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def batch_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D ``batch`` mesh over all ``n_devices`` ranks of the world (the
    whole world when None)."""
    return Mesh({"batch": world_size() if n_devices is None else n_devices})


def code_mesh(n_code: int, n_batch: int = 0) -> Mesh:
    """A mesh with a ``code`` axis of ``n_code`` ranks (parity checks shard
    over it: ``EdgeShardedBPDecoder``) and, for ``n_batch > 1``, a
    ``batch`` axis before it: ``[n_batch, n_code]``."""
    shape = {"code": n_code}
    if n_batch and n_batch > 1:
        shape = {"batch": n_batch, "code": n_code}
    return Mesh(shape)


def local_batch(global_batch: int, mesh: Union[Mesh, int, None]) -> int:
    """A rank's share of ``global_batch`` over the mesh's batch axis (or
    over ``mesh`` ranks, given a count); raises where it does not divide."""
    if isinstance(mesh, int):
        n = mesh
    else:
        n = mesh.width("batch") if mesh is not None else 1
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"{n} ranks")
    return global_batch // n


# ----------------------------------------------------------------------
# One host: spawn N ranks
# ----------------------------------------------------------------------

def _resolve(fn: Union[str, Callable]) -> Callable:
    if callable(fn):
        return fn
    module, _, attr = fn.partition(":")
    return getattr(importlib.import_module(module), attr)


def _rank_main(rank: int, nprocs: int, fn, args: tuple, device: str,
               backend: str, workdir: str, num_threads: Optional[int]) -> None:
    if num_threads:
        torch.set_num_threads(num_threads)
    initialize_distributed(num_processes=nprocs, process_id=rank,
                           backend=backend, device=device,
                           init_method="file://" + os.path.join(workdir,
                                                                "store"))
    try:
        out = _resolve(fn)(*args)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        path = os.path.join(workdir, f"rank{rank}.pkl")
        with open(path + ".part", "wb") as fp:
            pickle.dump(out, fp)
        os.replace(path + ".part", path)
    finally:
        dist.destroy_process_group()


def spawn(fn: Union[str, Callable], nprocs: int, args: tuple = (), *,
          device="cuda", backend: Optional[str] = None,
          num_threads: Optional[int] = None) -> list:
    """Run ``fn(*args)`` in ``nprocs`` ranks on this host, one process each,
    inside a process group; returns each rank's return value in rank order.

    ``fn`` is a function of an importable module, or its
    ``"module:function"`` name (the ranks import it afresh). ``device``
    "cuda" binds rank r to ``cuda:r`` under NCCL, which needs ``nprocs``
    cards; with ``backend="gloo"`` the ranks may share cards. On the CPU
    each rank runs ``num_threads`` threads (default: this process's threads
    split between the ranks). A rank that raises ends the run with its
    error."""
    if nprocs < 1:
        raise ValueError(f"need at least one rank, got {nprocs}")
    backend = resolve_backend(device, backend)
    if torch.device(device).type == "cuda":
        _check_cards(backend, nprocs)
    elif num_threads is None:
        num_threads = max(1, torch.get_num_threads() // nprocs)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ldpc_ranks_") as workdir:
        mp.spawn(_rank_main, nprocs=nprocs, join=True,
                 args=(nprocs, fn, tuple(args), str(device), backend,
                       workdir, num_threads))
        out = []
        for rank in range(nprocs):
            with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as fp:
                out.append(pickle.load(fp))
    return out


def run_ranks(entry: str, argv: list, ranks: int, device="cuda",
              backend: Optional[str] = None) -> tuple:
    """How a CLI reaches ``ranks`` ranks. In a process group already, or
    under ``torchrun`` (``WORLD_SIZE`` > 1: this process joins its world),
    this process is a rank: returns (False, None) and the CLI runs on; a
    world of another size than ``ranks`` raises (without a mesh every rank
    would repeat the whole run). Else, for more than one rank, spawns them
    on this host, each running ``entry(argv)`` (``"module:function"``), and
    returns (True, rank 0's return value)."""
    joined = dist.is_initialized()
    world = (dist.get_world_size() if joined
             else int(os.environ.get("WORLD_SIZE", "1")))
    if joined or world > 1:
        if world != max(ranks, 1):
            raise ValueError(
                f"the world has {world} ranks and the command line asks for "
                f"{max(ranks, 1)}: give the mesh flags for the whole world")
        if not joined:
            initialize_distributed(backend=backend, device=device)
        return False, None
    if ranks <= 1:
        return False, None
    return True, spawn(entry, ranks, args=(list(argv),), device=device,
                       backend=backend)[0]
