"""Adaptive Monte-Carlo sweep runner for one device (counterpart of
``ldpc_decoders_tpu.harness.runner``).

Each host-loop tick dispatches one super-batch chunk (sample -> transmit
-> decode -> tally) on the device: PyTorch draws the codebook rows
(codeword -1) and the channel's noise from the point's generator, and the
rest around the decode is two kernels (``ops/chunk_kernel.py``: C1 turns
the codeword and the draw into the decoder's input, C2 tallies its
decisions; their plain versions on the CPU). A chunk returns ONE packed
``[wec, bec]`` tally, extended by the iteration histogram (length
``ITER_HIST_LEN``) for decoders that track it (ADMM); on a CUDA device it
is copied without blocking into pinned host memory behind a CUDA event at
dispatch time, so the host waits only when it consumes that chunk,
pipeline-depth chunks later. A host decoder (LP) samples on the device,
decodes on the host and returns the same packed tally, at pipeline depth
1. The reference's
``while wec < min_wec`` termination is a host loop over chunks whose
stopping rule reads only consumed tallies, and every dispatched chunk is
consumed, so the min-wec estimator stays unbiased.

Each sweep point draws from its own ``torch.Generator`` seeded from
(seed, point index).

Several ranks (``mesh``, ``parallel/mesh.py``: one process per rank): each
rank of the mesh's ``batch`` axis decodes ``batch / N`` words a chunk from
a generator of its own, seeded from (seed, point index, rank, N); the
packed tally is summed over the batch axis (on the card at dispatch over
NCCL, on the host at consume over gloo: ``Mesh.device_tally``), so ``tot``
counts the global batch and every rank takes the same stop and pipeline
decisions from the same sums. Only rank 0 writes the Saver file. A mesh
with a ``code`` axis decodes through ``EdgeShardedBPDecoder`` (parity
checks sharded over that axis); the ranks of one code group draw the same
words, keyed on their batch coordinate alone, so a 1-D code mesh draws one
rank's words and each word counts once. A stateful decoder (ADMMA) trains
data-parallel over the batch axis.

A stateful decoder (ADMMA, which trains its MLP inside ``decode`` in train
mode) is one object for the whole run: its chunks decode one after the
other in dispatch order (``decode`` runs eagerly on the host's one
stream), so the training carries across chunks and sweep points.

A code ensemble runs through one runner: ``rotate_member`` swaps the
decoder to the next member's graph and tables (the kernels take their
tables as arguments, so nothing is rebuilt) with the member's Saver and
seed; ``run_rotating_members`` does that over a member list.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import OrderedDict, deque
from typing import Optional, Sequence

import numpy as np
import torch

from ldpc_decoders_tpu_torch.channels import CHANNELS
from ldpc_decoders_tpu_torch.channels.bsc import _LLRWrapped
from ldpc_decoders_tpu_torch.codes import get_code
from ldpc_decoders_tpu_torch.harness.saver import Saver
from ldpc_decoders_tpu_torch.ops import chunk_kernel
from ldpc_decoders_tpu_torch.parallel.bp_edge_sharded import (
    EdgeShardedBPDecoder,
)
from ldpc_decoders_tpu_torch.parallel.mesh import is_coordinator, local_batch
from ldpc_decoders_tpu_torch.utils import profiler

ITER_HIST_LEN = chunk_kernel.HIST_LEN   # counts above it clip to the last bin
PROFILE_FREQ = 20   # chunks of a point between ``--profile`` summaries


def start_host_copy(tally: torch.Tensor) -> tuple:
    """(host tally, CUDA event or None): a CUDA tally is copied without
    blocking into pinned host memory, behind an event the consumer waits
    on; a CPU tally is already on the host."""
    if not tally.is_cuda:
        return tally, None
    host = torch.empty(tally.shape, dtype=tally.dtype, pin_memory=True)
    host.copy_(tally, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def pipeline_depth(tick: int, depth: int, wec: np.ndarray,
                   chunks: np.ndarray, min_wec: int) -> int:
    """Chunks to keep in flight at dispatch ``tick``: a 1-2-4-... ramp up to
    ``depth``, capped, once every run still short of ``min_wec`` has seen
    errors, by the chunks the slowest of them still expects (``wec`` and
    ``chunks``: each run's consumed word errors and chunks), so easy points
    do not decode surplus chunks past the target."""
    eff = min(depth, 1 << min(tick - 1, 10))
    running = wec < min_wec
    if running.any() and (wec[running] > 0).all():
        expect = ((min_wec - wec[running]) * chunks[running]
                  / wec[running]).max()
        eff = min(eff, max(1, int(np.ceil(expect))))
    return eff


def point_generator(device, seed: int, idx: int, rank: int = 0,
                    ranks: int = 1) -> torch.Generator:
    """The generator of sweep point ``idx`` of a run seeded ``seed``, for
    rank ``rank`` of ``ranks`` along the batch axis; one rank draws the
    stream of a run without a mesh."""
    gen = torch.Generator(device=device)
    key = [seed, idx] if ranks == 1 else [seed, idx, rank, ranks]
    state = np.random.SeedSequence(key)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    return gen


@dataclasses.dataclass
class RunConfig:
    channel: str
    code: str
    decoder: str
    params: Sequence[float] = (0.1, 0.01)
    codeword: int = 0          # 0 / 1 / -1 = random codebook row
    min_wec: int = 100
    max_iter: int = 10
    mu: float = 3.0            # ADMM penalty
    eps: float = 1e-5          # ADMM convergence tolerance
    allow_pseudo: bool = False  # LP/ADMM: keep fractional pseudo-codewords
    layers: Sequence[int] = (100, 100)   # ADMMA: the MLP's hidden widths
    train: bool = False        # ADMMA: train online (exact projection)
    apprx: int = -1            # ADMMA: the MLP's last iteration, then exact
    iter_cap: int = 2000
    batch: int = 4096          # codewords per chunk
    seed: int = 0
    log_freq: float = 5.0
    max_words: Optional[int] = None   # safety cap per sweep point
    data_dir: Optional[str] = None
    cache_dir: Optional[str] = None   # ADMMA checkpoints ("cache" if None)
    profile: bool = False             # log span times every 20 chunks
    # BP message type, "float32" or "bfloat16": the kernel of that type
    # runs; nothing downgrades f32 to bf16 behind the caller's back.
    msg_dtype: str = "float32"
    # SPA inf handling: "reference" reproduces the reference decoder's
    # float64 inf/NaN cascade, which the golden curves depend on;
    # "saturate" is the clean decoder.
    inf_policy: str = "reference"
    # Chunks in flight ahead of the host sync point. 1 = synchronous.
    pipeline: int = 4
    # Ramp the pipeline up from depth 1 and cap in-flight chunks by the
    # expected chunks remaining to min_wec, so easy points do not decode
    # ``pipeline`` surplus chunks past the target.
    adaptive_pipeline: bool = True
    device: str = "cuda"

    def decoder_kwargs(self) -> dict:
        return dict(max_iter=self.max_iter, mu=self.mu, eps=self.eps,
                    allow_pseudo=self.allow_pseudo, layers=list(self.layers),
                    train=self.train, apprx=self.apprx,
                    iter_cap=self.iter_cap, cache_dir=self.cache_dir,
                    msg_dtype=self.msg_dtype, inf_policy=self.inf_policy,
                    device=self.device)


class MonteCarloRunner:
    """Runs one (channel, code, decoder) sweep to the target error count."""

    def __init__(self, cfg: RunConfig, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.code_sharded = mesh is not None and "code" in mesh.axis_names
        self.local_batch = local_batch(cfg.batch, mesh)
        if cfg.channel not in CHANNELS:
            raise ValueError(f"unknown channel {cfg.channel!r}")
        self.mod = CHANNELS[cfg.channel]
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available (use --device cpu for the "
                               "plain PyTorch route)")
        self.code = get_code(cfg.code)
        self.dec = (self._build_edge_sharded() if self.code_sharded
                    else self._make_decoder())
        inner = getattr(self.dec, "dec", None)
        self.host_only = getattr(inner, "host_only", False)
        self.track_hist = getattr(inner, "track_iter_hist", False)
        if mesh is not None and getattr(inner, "stateful", False):
            inner.set_mesh(mesh)
        # Where the chunk tally is summed over the batch axis.
        self._device_sum = (mesh is not None and mesh.device_tally
                            and not self.host_only)
        self._cb = None
        self._profile = None   # the recorder ``run`` keeps on for ``profile``
        if cfg.codeword == -1:
            if self.code.cb is None:
                raise ValueError("codeword -1 needs a code with a generator "
                                 "(the built-in codes)")
            self._cb = torch.as_tensor(self.code.cb, dtype=torch.int32,
                                       device=self.device)
        self._make_savers()

    def _make_decoder(self):
        cfg = self.cfg
        if cfg.decoder not in self.mod.DECODERS:
            raise NotImplementedError(
                f"decoder {cfg.decoder!r} is not ported yet (ROADMAP A)")
        return self.mod.DECODERS[cfg.decoder](self.code,
                                              **cfg.decoder_kwargs())

    def _build_edge_sharded(self):
        """The decoder of a mesh with a ``code`` axis: parity checks shard
        over it, behind the channel's LLR map."""
        cfg = self.cfg
        if cfg.decoder not in ("SPA", "MSA"):
            raise ValueError("code-axis sharding supports the LLR-domain BP "
                             "decoders (SPA/MSA) only")
        if cfg.channel == "bec":
            raise ValueError("code-axis sharding is LLR-domain; the ternary "
                             "BEC SPA does not shard")
        inner = EdgeShardedBPDecoder(
            self.code.parity_mtx, self.mesh, cfg.decoder,
            max_iter=cfg.max_iter, iter_cap=cfg.iter_cap,
            inf_policy=cfg.inf_policy, check_init=cfg.channel != "biawgn",
            device=self.device)
        return _LLRWrapped(inner, self.mod.llr)

    @property
    def rotatable(self) -> bool:
        """Whether the decoder can swap to another ensemble member's graph
        (the BP and erasure decoders)."""
        return hasattr(getattr(self.dec, "dec", None), "set_graph")

    def rotate_member(self, code_name: str,
                      seed: Optional[int] = None) -> None:
        """Point this runner at another ensemble member: the decoder takes
        the member's graph and tables (the kernels take their tables as
        arguments, so nothing is rebuilt), and the run's identity, logger
        and Saver become the member's. ``seed`` re-seeds the member's
        sweep."""
        if not self.rotatable:
            raise ValueError("decoder does not support member rotation")
        if self.cfg.codeword == -1:
            raise ValueError("random-codeword mode samples a member-"
                             "specific codebook; rotation requires "
                             "codeword 0/1")
        self.cfg = dataclasses.replace(
            self.cfg, code=code_name,
            **({"seed": seed} if seed is not None else {}))
        self.code = get_code(code_name)
        self.dec.dec.set_graph(self.code.graph)
        self._make_savers()

    def _make_savers(self) -> None:
        """Run identity (the JAX package's id-key convention), logger and
        Saver."""
        cfg = self.cfg
        id_keys = (["channel", "code", "decoder", "codeword", "min_wec"]
                   + list(self.dec.id_keys or []))
        cfg_vars = dataclasses.asdict(cfg)
        self.id_keys = id_keys
        self.id_vals = [cfg_vars[k] for k in id_keys]
        self.log = logging.getLogger(".".join(str(v) for v in self.id_vals))
        # Every rank holds the same summed tallies: rank 0 writes them.
        self.saver = (Saver(cfg.data_dir, list(zip(id_keys, self.id_vals)))
                      if cfg.data_dir and is_coordinator() else None)

    # ------------------------------------------------------------------
    def _transmit(self, param, gen: torch.Generator, want: str) -> tuple:
        """Draw a chunk's words and channel noise from ``gen`` (codeword -1:
        the codebook rows first) and send them: (the rows ``idx`` or None,
        what ``chunk_kernel.transmit`` returns for ``want``)."""
        cfg, batch = self.cfg, self.local_batch
        idx = None
        if cfg.codeword == -1:
            idx = torch.randint(0, self._cb.shape[0], (batch,),
                                generator=gen, device=self.device)
        noise = self.mod.draw((batch, self.code.get_n()), gen, self.device)
        return idx, chunk_kernel.transmit(cfg.channel, noise, param,
                                          cfg.codeword, idx, self._cb, want)

    def _chunk(self, param, gen: torch.Generator) -> torch.Tensor:
        """One super-batch -> the packed ``[wec, bec]`` tally (plus the
        iteration histogram for decoders that track it), on device."""
        idx, inp = self._transmit(param, gen, self.dec.takes)
        x_hat, aux = self.dec.decode_input(inp, param, gen)
        return chunk_kernel.tally(
            x_hat, self.cfg.codeword, idx, self._cb,
            iters=aux["iters"] if self.track_hist else None)

    def _host_chunk(self, param, gen: torch.Generator) -> torch.Tensor:
        """Host decoders (LP): sample and send on the device, decode on the
        host. Returns the same packed ``[wec, bec]`` tally as the device
        chunks, so ``consume`` does not care about the route."""
        idx, gamma = self._transmit(param, gen, "llr")
        x_hat, _ = self.dec.decode_input(gamma, param, gen)
        x = chunk_kernel.codeword_plane(
            gamma.shape, self.cfg.codeword,
            None if idx is None else idx.cpu(),
            None if self._cb is None else self._cb.cpu(), "cpu").numpy()
        errs = (x_hat != x.astype(x_hat.dtype)).sum(axis=-1)
        return torch.tensor([(errs > 0).sum(), errs.sum()], dtype=torch.int64)

    def _dispatch(self, param, gen: torch.Generator):
        """Enqueue a chunk; returns (host tally, CUDA event or None)."""
        if self.host_only:
            return self._host_chunk(param, gen), None
        tally = self._chunk(param, gen)
        if self._device_sum:
            self.mesh.all_reduce(tally, "batch")
        return start_host_copy(tally)

    def _generator(self, idx: int) -> torch.Generator:
        rank = ((self.mesh.index("batch"), self.mesh.width("batch"))
                if self.mesh is not None else ())
        return point_generator(self.device, self.cfg.seed, idx, *rank)

    # ------------------------------------------------------------------
    def run_param(self, param: float, gen: torch.Generator) -> OrderedDict:
        """One sweep point to ``min_wec`` word errors (or ``max_words``),
        its Saver entry written: the point's status. Inside a ``point``
        span of the recorder that is on (``utils/profiler.py``)."""
        profiler.follow_torch()
        with profiler.span("point", param):
            return self._run_param(param, gen)

    def _run_param(self, param: float, gen: torch.Generator) -> OrderedDict:
        cfg = self.cfg
        tot = wec = bec = 0
        hist = np.zeros(ITER_HIST_LEN, dtype=np.int64)
        t_start = t_log = time.time()
        # Throughput counts from after the first chunk lands (kernel
        # build and warm-up excluded).
        t_warm = None
        tot_warm = 0
        consumed = 0
        pending: deque = deque()

        def status() -> OrderedDict:
            wer = wec / tot if tot else 0.0
            ber = bec / (tot * self.code.get_n()) if tot else 0.0
            vals = OrderedDict([("tot", int(tot)), ("wec", int(wec)),
                                ("wer", float(wer)), ("bec", int(bec)),
                                ("ber", float(ber))])
            if self.track_hist and hist.sum():
                avg = float(hist @ np.arange(ITER_HIST_LEN) / hist.sum())
                vals["dec"] = {"average": avg, "iter": hist.tolist()}
            if t_warm is not None and tot > tot_warm:
                wps = (tot - tot_warm) / (time.time() - t_warm)
            else:
                elapsed = time.time() - t_start
                wps = tot / elapsed if elapsed > 0 else 0.0
            vals["words_per_sec"] = float(wps)
            return vals

        def log_status():
            with profiler.span("log"):
                v = status()
                self.log.info(", ".join(
                    f"{k.upper()}:{v[k]}" for k in
                    ("tot", "wec", "wer", "bec", "ber", "words_per_sec")))
                if self.saver:
                    self.saver.add(param, v)

        def consume():
            nonlocal tot, wec, bec, hist, t_warm, tot_warm, consumed
            host, event = pending.popleft()
            with profiler.span("wait"):
                if event is not None:
                    event.synchronize()
                if self.mesh is not None and not self._device_sum:
                    self.mesh.host_sum(host, "batch")
            arr = host.numpy()
            consumed += 1
            wec += int(arr[0])
            bec += int(arr[1])
            tot += cfg.batch
            if self.track_hist:
                hist += arr[2:]
            if t_warm is None:
                t_warm = time.time()
                tot_warm = tot

        depth = 1 if self.host_only else max(1, int(cfg.pipeline))

        def effective_depth(tick: int) -> int:
            if not cfg.adaptive_pipeline:
                return depth
            return pipeline_depth(tick, depth, np.array([wec]),
                                  np.array([consumed]), cfg.min_wec)

        chunk_i = 0
        while wec < cfg.min_wec:
            chunk_i += 1
            with profiler.span("dispatch"):
                pending.append(self._dispatch(param, gen))
            while len(pending) >= effective_depth(chunk_i):
                consume()
            if time.time() - t_log > cfg.log_freq:
                t_log = time.time()
                log_status()
            if self._profile is not None and chunk_i % PROFILE_FREQ == 0:
                self.log.info("Summary at[%d] for[%d]: [%s]", chunk_i,
                              PROFILE_FREQ, self._profile.summary())
            if cfg.max_words and tot + cfg.batch * len(pending) >= cfg.max_words:
                self.log.warning("max_words cap hit at %d", tot)
                break
        # Drain in-flight chunks: their inclusion is outcome-independent.
        while pending:
            consume()
        self.last_dispatch_stats = {"dispatched": chunk_i,
                                    "consumed": consumed}
        profiler.count("chunks_dispatched", chunk_i)
        profiler.count("chunks_consumed", consumed)
        log_status()
        return status()

    def run(self) -> dict:
        """Full sweep. Returns {param: metrics}. With ``profile`` (and no
        recorder on already) a recorder is on for the sweep, and every
        ``PROFILE_FREQ`` chunks of a point its summary is logged."""
        if self.cfg.profile and profiler.active() is None:
            self._profile = profiler.enable()
        try:
            results = {}
            for idx, param in enumerate(self.cfg.params):
                self.log.info("Starting parameter: %f", param)
                results[param] = self.run_param(param, self._generator(idx))
        finally:
            if self._profile is not None:
                self._profile = None
                profiler.disable()
        self.log.info("Done!")
        return results


def run_rotating_members(cfg: RunConfig, member_names, mesh=None) -> dict:
    """Monte-Carlo a code ensemble one member at a time through one runner
    (:meth:`MonteCarloRunner.rotate_member`), member ``idx`` seeded
    ``cfg.seed + idx`` so the members' channel noise is independent.
    Per-member ``min_wec`` stop and per-member Saver files, as independent
    per-member runs have them. Returns ``{member: {param: metrics}}``."""
    runner = MonteCarloRunner(dataclasses.replace(cfg, code=member_names[0]),
                              mesh=mesh)
    results = {}
    for idx, name in enumerate(member_names):
        runner.rotate_member(name, seed=cfg.seed + idx)
        results[name] = runner.run()
    return results
