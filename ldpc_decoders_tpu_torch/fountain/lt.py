"""LT fountain codes: robust-soliton sampling and batched incremental
peeling (counterpart of ``ldpc_decoders_tpu.fountain.lt``).

Measures how many received symbols an LT code needs before the peeling
(ripple) decoder succeeds (MacKay Fig 50.4), as the JAX package does: one
incremental process per sim (peel to a fixpoint, and only when stuck
activate more symbols; peeling is confluent, so this finds the minimal
successful prefix), a batch of sims at a time.

Degree distributions and graph sampling are host numpy, the JAX package's
own code kept here as a copy: the same ``np.random.Generator`` gives the
same graphs, draw for draw.

Two peel engines, equal in ``result``, ``resolved`` and ``est`` where
resolved:

- ``engine="sparse"``: the sorted-edge peel. On CPU tensors it is the plain
  PyTorch version (``ops/lt_kernel.py:lt_peel_plain``, the JAX package's
  ``_segment``); on CUDA tensors it launches the hand-written kernel
  ``csrc/lt_peel.cu`` (one CTA per sim builds its edge layout and runs the
  whole peel in one launch) or raises.
- ``engine="dense"``: the plain PyTorch version of the JAX package's dense
  engine: a 0/1 generator G [B, n, k] per batch, every peel round two
  batched float32 products (``torch.bmm``; TF32 is switched off, so the
  integer counts are exact). G takes 4 n k bytes per sim (480 MB at k=10000,
  n=12000); a batch whose G does not fit the card raises.
- ``engine="auto"`` is ``"sparse"``: the kernel on CUDA, the plain sparse
  version on the CPU. The JAX package picks the dense engine on an
  accelerator (``ldpc_decoders_tpu/fountain/lt.py:227-229``) because
  lane-axis gathers were slow on the TPU; the H100 gathers natively, and
  the dense form would read G twice per round (about 30 GB per round at
  the CLI's batch of 64).

The edge lists ship from the host as ``sample_edges(light=True)`` draws
them, through pinned memory when the simulator's device is a card. The
sorted-segment tables are built on the device: by the kernel itself on a
card (a counting sort per sim), by ``ops/lt_kernel.py:edge_layout``
(PyTorch's sort and bincounts) for the plain version.

CLI: ``python -m ldpc_decoders_tpu_torch.fountain.lt k n c delta count``.
With ``--mesh N`` each of N ranks (one process each, spawned by the CLI
where no process group exists) samples and peels ``batch / N`` sims of
every batch with its own rng stream and sampler thread, and rank 0 gathers
the results in rank order and writes the file: the host sampler, which
sets the pace, runs in N processes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ldpc_decoders_tpu_torch.ops import lt_kernel
from ldpc_decoders_tpu_torch.parallel.mesh import local_batch


# ----------------------------------------------------------------------
# Degree distributions (reference luby.py:91-126)
# ----------------------------------------------------------------------

def ideal_soliton(k: int) -> np.ndarray:
    """rho(1) = 1/k, rho(d) = 1/(d(d-1)) for d = 2..k."""
    rho = np.zeros(k)
    rho[0] = 1.0 / k
    d = np.arange(2, k + 1)
    rho[d - 1] = 1.0 / (d * (d - 1.0))
    return rho


def robust_tau(k: int, c: float, delta: float) -> np.ndarray:
    """The robust-soliton boost term with its spike at ceil(k/R),
    R = c*sqrt(k)*ln(k/delta)."""
    tau = np.zeros(k)
    R = c * np.sqrt(k) * np.log(k / delta)
    spike = int(np.ceil(k / R))
    d = np.arange(1, spike - 1 + 1)
    tau[d - 1] = R / (k * d)
    tau[spike - 1] = np.log(R / delta) * R / k
    return tau


def robust_soliton_parts(k: int, c: float, delta: float) -> tuple:
    """(rho, tau, normalized mu): the decomposition the soliton plot shows."""
    rho = ideal_soliton(k)
    tau = robust_tau(k, c, delta)
    mu = rho + tau
    return rho, tau, mu / mu.sum()


def robust_soliton(k: int, c: float, delta: float) -> np.ndarray:
    """Normalized rho + tau with spike at ceil(k/R), R = c*sqrt(k)*ln(k/d)."""
    return robust_soliton_parts(k, c, delta)[2]


# ----------------------------------------------------------------------
# Generator sampling (host): distinct column supports, soliton weights
# ----------------------------------------------------------------------

def sample_edges(rng: np.random.Generator, omega: np.ndarray, k: int, n: int,
                 e_pad: int, light: bool = False):
    """One sim's edge tables, in the segment-friendly sorted form.

    Column j gets weight w_j ~ omega and a uniformly random w_j-subset of
    the k message bits. Returns a dict of per-sim arrays:
    - edge_sym [E_pad] int32, NON-DECREASING (edges emitted column by
      column); pads use symbol n;
    - edge_var [E_pad] int32 (pads use variable k);
    and unless ``light`` (the draws are the same either way):
    - indptr_sym [n+2] int32: edge range of each symbol (pads in seg n);
    - perm_var [E_pad] int32: permutation putting edges in variable order;
    - indptr_var [k+2] int32: range of each variable in that order.
    """
    weights = rng.choice(np.arange(1, k + 1), size=n, p=omega)
    total = int(weights.sum())
    if total > e_pad:
        raise ValueError(f"edge budget {e_pad} < sampled {total}; "
                         "raise e_pad")
    sym = np.repeat(np.arange(n, dtype=np.int32), weights)
    var = np.empty(total, dtype=np.int32)
    pos = 0
    for w in weights:
        var[pos:pos + w] = rng.choice(k, size=w, replace=False)
        pos += w
    edge_sym = np.full(e_pad, n, dtype=np.int32)
    edge_var = np.full(e_pad, k, dtype=np.int32)
    edge_sym[:total] = sym
    edge_var[:total] = var
    if light:
        return dict(edge_sym=edge_sym, edge_var=edge_var)

    indptr_sym = np.zeros(n + 2, dtype=np.int32)
    np.cumsum(np.bincount(edge_sym, minlength=n + 1), out=indptr_sym[1:])
    perm_var = np.argsort(edge_var, kind="stable").astype(np.int32)
    indptr_var = np.zeros(k + 2, dtype=np.int32)
    np.cumsum(np.bincount(edge_var, minlength=k + 1), out=indptr_var[1:])
    return dict(edge_sym=edge_sym, edge_var=edge_var,
                indptr_sym=indptr_sym, perm_var=perm_var,
                indptr_var=indptr_var)


def default_e_pad(omega: np.ndarray, n: int) -> int:
    d = np.arange(1, omega.size + 1)
    mean = float(omega @ d)
    var = float(omega @ (d - mean) ** 2)
    return int(n * mean + 8.0 * np.sqrt(n * var) + 64)


def _as_int32(x, device: torch.device) -> torch.Tensor:
    """A table (tensor, numpy or JAX array) as an int32 tensor on
    ``device``; a pinned host tensor copies without blocking."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.int32))
    if x.dtype != torch.int32:
        raise ValueError(f"LT tables must be int32, got {x.dtype}")
    return x.to(device, non_blocking=True)


# ----------------------------------------------------------------------
# The simulator
# ----------------------------------------------------------------------

@dataclasses.dataclass
class LTSimulator:
    """Batched LT simulation: minimal number of received symbols for a
    successful peeling decode, per sim, on ``device``."""

    k: int
    n: int
    c: float
    delta: float
    e_pad: Optional[int] = None
    # Plain engines: peel rounds between checks of whether every sim is
    # done (one host sync each). It changes no result.
    seg_iters: int = 64
    engine: str = "auto"
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.omega = robust_soliton(self.k, self.c, self.delta)
        if self.e_pad is None:
            self.e_pad = default_e_pad(self.omega, self.n)
        if self.engine == "auto":
            self.engine = "sparse"
        if self.engine not in ("sparse", "dense"):
            raise ValueError(f"unknown LT engine {self.engine!r}")
        if self.seg_iters < 1:
            raise ValueError(f"seg_iters must be positive, got {self.seg_iters}")

    # -- host sampling --------------------------------------------------
    def sample_batch(self, rng: np.random.Generator, batch: int) -> dict:
        """``batch`` sims' edge lists and messages as int32 host tensors
        (pinned when the device is a card): the JAX package's
        ``sample_batch`` draws, in its order."""
        pin = self.device.type == "cuda"
        sym = torch.empty((batch, self.e_pad), dtype=torch.int32,
                          pin_memory=pin)
        var = torch.empty((batch, self.e_pad), dtype=torch.int32,
                          pin_memory=pin)
        sym_np, var_np = sym.numpy(), var.numpy()
        for i in range(batch):
            t = sample_edges(rng, self.omega, self.k, self.n, self.e_pad,
                             light=True)
            sym_np[i] = t["edge_sym"]
            var_np[i] = t["edge_var"]
        msg = torch.empty((batch, self.k), dtype=torch.int32, pin_memory=pin)
        msg.numpy()[:] = rng.integers(0, 2, size=(batch, self.k))
        return {"edge_sym": sym, "edge_var": var, "msg": msg}

    # -- dense engine: peel rounds as batched products --------------------
    def _dense(self, edge_sym, edge_var, msg) -> tuple:
        """``_init_dense`` / ``_segment_dense`` of the JAX package: the same
        peel and jump, every per-symbol and per-variable reduction a float32
        ``torch.bmm`` over G (0/1 operands, integer sums below 2^24: exact),
        the jump fused into the round that resolves its symbol."""
        n, k = self.n, self.k
        B = msg.shape[0]
        dev = msg.device
        size = B * n * k
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            if torch.backends.cuda.matmul.allow_tf32:
                raise RuntimeError("TF32 products could not be switched off")
            free, _ = torch.cuda.mem_get_info(dev)
            free += (torch.cuda.memory_reserved(dev)
                     - torch.cuda.memory_allocated(dev))
            if 4 * size > free:
                raise MemoryError(
                    f"the dense engine's G of {B} sims takes {4 * size} bytes,"
                    f" the card has {free} free: use a smaller batch or the "
                    "sparse engine")
        # G by one scatter, straight into float32; pads hit a guard element.
        flat = torch.zeros(size + 1, dtype=torch.float32, device=dev)
        row = torch.arange(B, device=dev)[:, None] * n
        idx = torch.where(edge_sym < n,
                          (row + edge_sym.long()) * k + edge_var.long(), size)
        flat[idx.flatten()] = 1.0
        g = flat[:-1].view(B, n, k)

        deg = g.sum(-1).to(torch.int32)                          # [B, n]
        rcv = torch.bmm(g, msg.to(torch.float32)[..., None])[..., 0]
        rcv = rcv.to(torch.int32) % 2
        resolved = torch.zeros((B, k), dtype=torch.bool, device=dev)
        est = torch.zeros((B, k), dtype=torch.int32, device=dev)
        m = torch.full((B,), k, dtype=torch.int64, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        result = torch.full((B,), n, dtype=torch.int32, device=dev)
        sym_idx = torch.arange(n, device=dev)
        for it in range(k + n + 2):
            prefix = sym_idx < m[:, None]
            success = ~((deg > 0) & prefix).any(-1)
            ripple = (deg == 1) & prefix
            grow = ~done & ~success & ~ripple.any(-1)
            nxt = torch.where((deg == 1) & ~prefix, sym_idx, n).min(-1).values
            can_jump = grow & (nxt < n)
            fail = grow & (nxt >= n)
            ripple = ripple | (can_jump[:, None] & (sym_idx == nxt[:, None]))

            r2 = torch.stack([ripple, ripple & (rcv > 0)], 1)    # [B, 2, n]
            kv = torch.bmm(r2.to(torch.float32), g)              # [B, 2, k]
            newly = ~resolved & (kv[:, 0] > 0)
            est_n = torch.where(newly, (kv[:, 1] > 0).to(torch.int32), est)
            n2 = torch.stack([newly, newly & (est_n > 0)], -1)   # [B, k, 2]
            sv = torch.bmm(g, n2.to(torch.float32)).to(torch.int32)

            act = ~done
            act2 = act[:, None]
            resolved = torch.where(act2, resolved | newly, resolved)
            est = torch.where(act2, est_n, est)
            deg = torch.where(act2, deg - sv[..., 0], deg)
            rcv = torch.where(act2, (rcv + sv[..., 1]) % 2, rcv)
            result = torch.where(act & success, m.to(torch.int32), result)
            m = torch.where(act & can_jump, nxt + 1, m)
            done = done | (act & (success | fail))
            if (it + 1) % self.seg_iters == 0 and bool(done.all()):
                break
        return result, est, resolved

    # -- public API -------------------------------------------------------
    def simulate(self, tables) -> tuple:
        """Run sampled tables (``edge_sym``, ``edge_var``, ``msg``; other
        keys are ignored) to completion on the simulator's device. Returns
        (result [B] int32, est [B, k] int32, resolved [B, k] bool)."""
        t = [_as_int32(tables[key], self.device)
             for key in ("edge_sym", "edge_var", "msg")]
        if self.engine == "dense":
            return self._dense(*t)
        return lt_kernel.lt_peel(*t, self.n, seg_iters=self.seg_iters)[:3]

    def run(self, rng: np.random.Generator, batch: int):
        """Returns (num_symbols [B], est [B,k], resolved [B,k]) as numpy."""
        res, est, resolved = self.simulate(self.sample_batch(rng, batch))
        return res.cpu().numpy(), est.cpu().numpy(), resolved.cpu().numpy()


def batch_sizes(count: int, batch: int, mesh=None) -> list:
    """The global sizes of the batches of a run of ``count`` sims; each
    must divide over the mesh's ranks (``local_batch`` raises)."""
    if count <= 0:
        return []
    if batch < 1:
        raise ValueError(f"batch must be positive, got {batch}")
    sizes = [min(batch, count - i) for i in range(0, count, batch)]
    for b in sizes:
        local_batch(b, mesh)
    return sizes


def rank_rng(seed: int, done: int, rank: int = 0,
             ranks: int = 1) -> np.random.Generator:
    """The rng of rank ``rank`` of ``ranks`` in a run seeded ``seed`` that
    resumes after ``done`` committed sims: one rank draws the stream of a
    run without a mesh, ``(seed, done)``; rank r of N > 1 draws
    ``(seed, done, r, N)`` (the counterpart of the harness's
    ``point_generator``)."""
    key = [seed, done] if ranks == 1 else [seed, done, rank, ranks]
    return np.random.default_rng(key)


def stream_batches(sim: LTSimulator, rng: np.random.Generator, count: int,
                   batch: int, mesh=None):
    """Decode ``count`` sims in batches of ``batch``, yielding each batch's
    num-symbols results (numpy). Host graph sampling overlaps the peel of
    the previous batch: one sampler thread stays exactly a batch ahead, and
    the rng is only ever touched from that thread, one job at a time, so
    the stream is deterministic. ``count <= 0`` yields nothing and samples
    nothing.

    With a ``mesh`` each rank samples and peels its share of every batch
    from its own ``rng`` and thread, and every rank yields the whole
    batch's results, gathered in rank order. A batch that does not divide
    over the ranks raises before anything is sampled."""
    local = [local_batch(b, mesh) for b in batch_sizes(count, batch, mesh)]
    if not local:
        return
    from concurrent.futures import ThreadPoolExecutor

    ex = ThreadPoolExecutor(1)
    fut = ex.submit(sim.sample_batch, rng, local[0])
    try:
        for j in range(len(local)):
            tables = fut.result()
            if j + 1 < len(local):
                fut = ex.submit(sim.sample_batch, rng, local[j + 1])
            res = sim.simulate(tables)[0].cpu()
            if mesh is not None:
                res = mesh.host_gather(res, "batch")
            yield res.numpy()
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


# ----------------------------------------------------------------------
# CLI: python -m ldpc_decoders_tpu_torch.fountain.lt
# ----------------------------------------------------------------------

def main(argv=None):
    import argparse
    import logging
    import os
    import sys

    import torch.distributed as dist

    from ldpc_decoders_tpu_torch.harness.saver import Saver
    from ldpc_decoders_tpu_torch.parallel.mesh import (
        BACKENDS,
        batch_mesh,
        is_coordinator,
        run_ranks,
    )
    from ldpc_decoders_tpu_torch.utils.file import load_json, resolve_data_dir_os

    p = argparse.ArgumentParser(description="LT fountain-code simulation")
    p.add_argument("k", type=int)
    p.add_argument("n", type=int)
    p.add_argument("c", type=float)
    p.add_argument("delta", type=float)
    p.add_argument("count", type=int,
                   help="total sims in the result file (resumes an existing "
                        "one)")
    p.add_argument("--batch", type=int, default=64,
                   help="sims per peel launch, over all ranks")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "sparse", "dense"],
                   help="auto = sparse: the CUDA kernel on a card, the plain "
                        "sorted-edge peel on the CPU; dense = batched "
                        "products over a 0/1 generator per sim")
    p.add_argument("--mesh", type=int, default=0,
                   help="sample and peel each batch over N ranks, one "
                        "process (and one card) each (0 = one process)")
    p.add_argument("--dist-backend", choices=BACKENDS, default=None,
                   help="process-group backend of a mesh: nccl (one card "
                        "per rank, the default on cuda) or gloo (the CPU's; "
                        "on cuda it lets ranks share cards)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_dir",
                   default=resolve_data_dir_os("decoders") + "/data")
    p.add_argument("--console", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "engines)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    if args.mesh < 0:
        p.error("--mesh counts ranks (0 = one process)")

    id_keys = ["k", "n", "c", "delta"]
    id_val = [str(vars(args)[key]) for key in id_keys]
    ids = list(zip(["type"] + id_keys, ["luby"] + id_val))
    path = os.path.join(args.data_dir, "-".join(["luby"] + id_val) + ".json")

    def committed() -> list:
        existing = load_json(path)
        return ([int(v) for v in existing["arr"]]
                if existing and "arr" in existing else [])

    ranks = max(args.mesh, 1)
    if not dist.is_initialized():
        try:
            batch_sizes(args.count - len(committed()), args.batch, ranks)
        except ValueError as e:
            p.error(f"--mesh {ranks}: {e}")
    if run_ranks("ldpc_decoders_tpu_torch.fountain.lt:main", argv, ranks,
                 args.device, args.dist_backend)[0]:
        return

    mesh = batch_mesh(args.mesh) if args.mesh else None
    logging.basicConfig(format="%(name)s|%(message)s", level=logging.INFO)
    saver = Saver(args.data_dir, ids) if is_coordinator() else None
    log = logging.getLogger(".".join(id_val))

    sim = LTSimulator(args.k, args.n, args.c, args.delta,
                      engine=args.engine, device=args.device)
    # Resume: ``count`` is the total; an existing file's sims are kept and
    # extended, from streams seeded by (seed, #existing): rank 0 reads the
    # file, and rank r of N > 1 draws from (seed, #existing, r, N).
    arr = committed() if saver else []
    n_done = mesh.host_broadcast(len(arr)) if mesh is not None else len(arr)
    if arr:
        log.info("resuming from %d committed sims", len(arr))
    rng = rank_rng(args.seed, n_done,
                   mesh.index("batch") if mesh is not None else 0, ranks)
    for res in stream_batches(sim, rng, args.count - n_done, args.batch,
                              mesh):
        if saver:
            arr.extend(int(r) for r in res)
            log.info("sims=%d mean=%.1f std=%.1f", len(arr),
                     float(np.mean(arr)), float(np.std(arr)))
            saver.add_all({"arr": arr})
    log.info("Finished all!")


if __name__ == "__main__":
    main()
