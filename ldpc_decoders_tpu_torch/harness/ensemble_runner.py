"""Joint ensemble Monte-Carlo runner: every member of a code ensemble in
each chunk (counterpart of ``ldpc_decoders_tpu.harness.ensemble_runner``;
``campaign --joint-ensemble``).

A chunk samples B words for each member still running, decodes them
through :class:`~ldpc_decoders_tpu_torch.decoders.bp_ensemble.EnsembleBPDecoder`
(or ``EnsembleBECSPADecoder`` on the BEC: one kernel launch per member) and
returns ONE packed ``[2, A]`` tally (row 0 word errors, row 1 bit errors,
one column per member decoded), copied without blocking into pinned host
memory behind a CUDA event, as ``MonteCarloRunner._dispatch`` does.

Member ``g`` draws its channel noise from its own generator, the one a
per-member run seeded ``cfg.seed + g`` uses at that sweep point, so its
results do not depend on which other members run beside it. The
``min_wec`` stop is per member: a member whose consumed tallies reach
``min_wec`` is not decoded in later chunks (its chunks in flight still
count, as in a per-member run), and a sweep point ends when every member
has reached it. Chunks in flight follow ``MonteCarloRunner``'s rule, for
the slowest running member.

Each member writes through its own Saver, with the file name a per-member
run gives it. ``words_per_sec`` is the words of all members decoded per
second.

With a ``mesh`` (a ``batch`` axis only) each rank decodes ``batch / N``
words of each member a chunk, member ``g`` from the generator rank r's
rotating run uses, and the ``[2, A]`` tally is summed over the ranks where
``MonteCarloRunner`` sums its own (``Mesh.device_tally``). Only rank 0
writes.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict, deque
from typing import Sequence

import numpy as np
import torch

from ldpc_decoders_tpu_torch.channels import CHANNELS
from ldpc_decoders_tpu_torch.codes import get_code
from ldpc_decoders_tpu_torch.decoders.bp_ensemble import (
    EnsembleBECSPADecoder,
    EnsembleBPDecoder,
)
from ldpc_decoders_tpu_torch.harness.runner import (
    RunConfig,
    pipeline_depth,
    point_generator,
    start_host_copy,
)
from ldpc_decoders_tpu_torch.harness.saver import Saver
from ldpc_decoders_tpu_torch.ops import chunk_kernel
from ldpc_decoders_tpu_torch.parallel.mesh import is_coordinator, local_batch


class EnsembleMonteCarloRunner:
    """One (channel, decoder) sweep over G same-shape ensemble members.

    ``cfg.code`` is only a label; ``member_names`` are resolved through the
    code registry. SPA / MSA on the BSC and biAWGN, the ternary erasure SPA
    on the BEC (the decoders of the ensemble campaigns)."""

    def __init__(self, cfg: RunConfig, member_names: Sequence[str],
                 mesh=None):
        if mesh is not None and "code" in mesh.axis_names:
            raise ValueError("the joint ensemble runner shards the batch "
                             "only; a mesh with a code axis needs the "
                             "edge-sharded decoder (MonteCarloRunner)")
        if cfg.decoder not in ("SPA", "MSA"):
            raise ValueError("ensemble runner supports SPA/MSA only")
        if cfg.codeword == -1:
            raise ValueError("ensemble members are parity-only codes; "
                             "random-codeword mode needs a generator")
        self.cfg = cfg
        self.mesh = mesh
        self.local_batch = local_batch(cfg.batch, mesh)
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available (use --device cpu for the "
                               "plain PyTorch route)")
        self.member_names = list(member_names)
        self.mod = CHANNELS[cfg.channel]
        graphs = [get_code(n).graph for n in self.member_names]
        self.n_var = graphs[0].n_var
        self.G = len(graphs)
        kw = dict(max_iter=cfg.max_iter, iter_cap=cfg.iter_cap,
                  device=self.device)
        if cfg.channel == "bec":
            # MSA is SPA on the BEC, as in the reference.
            self.dec = EnsembleBECSPADecoder(graphs, **kw)
        else:
            self.dec = EnsembleBPDecoder(
                graphs, cfg.decoder, msg_dtype=cfg.msg_dtype,
                inf_policy=cfg.inf_policy,
                check_init=cfg.channel != "biawgn", **kw)
        self.log = logging.getLogger(
            ".".join([cfg.channel, cfg.code, cfg.decoder, "ensemble"]))
        self.savers = []
        if cfg.data_dir and is_coordinator():
            for name in self.member_names:
                ids = [("channel", cfg.channel), ("code", name),
                       ("decoder", cfg.decoder), ("codeword", cfg.codeword),
                       ("min_wec", cfg.min_wec), ("max_iter", cfg.max_iter)]
                self.savers.append(Saver(cfg.data_dir, ids))

    # ------------------------------------------------------------------
    def _chunk(self, param, gens: list, active: list) -> torch.Tensor:
        """B words for each member of ``active`` -> the packed [2, A]
        tally on the device. Each member's channel output is written into
        its slice of the decoder's input."""
        cfg = self.cfg
        bec = cfg.channel == "bec"
        shape = (self.local_batch, self.n_var)
        soft = torch.empty((len(active), *shape),
                           dtype=torch.int32 if bec else torch.float32,
                           device=self.device)
        for i, g in enumerate(active):
            noise = self.mod.draw(shape, gens[g], self.device)
            chunk_kernel.transmit(cfg.channel, noise, param, cfg.codeword,
                                  want="sym" if bec else "llr", out=soft[i])
        x_hat, _ = self.dec.decode(soft, members=active)
        return chunk_kernel.tally(x_hat, cfg.codeword)

    def run_param(self, param: float, gens: list) -> list:
        cfg = self.cfg
        G = self.G
        tot = np.zeros(G, np.int64)
        wec = np.zeros(G, np.int64)
        bec = np.zeros(G, np.int64)
        t_start = t_log = time.time()
        # Throughput counts from after the first chunk lands.
        t_warm = None
        words_warm = 0

        def member_status(g) -> OrderedDict:
            t = int(tot[g])
            vals = OrderedDict([
                ("tot", t), ("wec", int(wec[g])),
                ("wer", float(wec[g] / t) if t else 0.0),
                ("bec", int(bec[g])),
                ("ber", float(bec[g] / (t * self.n_var)) if t else 0.0)])
            if t_warm is not None and tot.sum() > words_warm:
                wps = (tot.sum() - words_warm) / (time.time() - t_warm)
            else:
                elapsed = time.time() - t_start
                wps = tot.sum() / elapsed if elapsed > 0 else 0.0
            vals["words_per_sec"] = float(wps)
            return vals

        def log_and_save():
            self.log.info(
                "TOT:[%d..%d] (x%d members), WEC:[%d..%d]", tot.min(),
                tot.max(), G, wec.min(), wec.max())
            for g, saver in enumerate(self.savers):
                saver.add(param, member_status(g))

        pending: deque = deque()
        depth = max(1, int(cfg.pipeline))

        def effective_depth(tick: int) -> int:
            if not cfg.adaptive_pipeline:
                return depth
            return pipeline_depth(tick, depth, wec, tot // cfg.batch,
                                  cfg.min_wec)

        def consume():
            nonlocal t_warm, words_warm
            host, event, active = pending.popleft()
            if event is not None:
                event.synchronize()
            if self.mesh is not None and not self.mesh.device_tally:
                self.mesh.host_sum(host, "batch")
            arr = host.numpy()
            wec[active] += arr[0]
            bec[active] += arr[1]
            tot[active] += cfg.batch
            if t_warm is None:
                t_warm = time.time()
                words_warm = int(tot.sum())

        chunk_i = 0
        while True:
            active = [g for g in range(G) if wec[g] < cfg.min_wec]
            if not active:
                break
            chunk_i += 1
            tally = self._chunk(param, gens, active)
            if self.mesh is not None and self.mesh.device_tally:
                self.mesh.all_reduce(tally, "batch")
            pending.append((*start_host_copy(tally), active))
            while len(pending) >= effective_depth(chunk_i):
                consume()
            if time.time() - t_log > cfg.log_freq:
                t_log = time.time()
                log_and_save()
            if (cfg.max_words
                    and tot.max() + cfg.batch * len(pending) >= cfg.max_words):
                self.log.warning("max_words cap hit at %d", tot.max())
                break
        # Drain in-flight chunks: their inclusion is outcome-independent.
        while pending:
            consume()
        log_and_save()
        return [member_status(g) for g in range(G)]

    def run(self) -> dict:
        """Full sweep. Returns {member_name: {param: metrics}}."""
        results = {name: {} for name in self.member_names}
        for idx, param in enumerate(self.cfg.params):
            self.log.info("Starting parameter: %f (G=%d members)", param,
                          self.G)
            rank = ((self.mesh.index("batch"), self.mesh.width("batch"))
                    if self.mesh is not None else ())
            gens = [point_generator(self.device, self.cfg.seed + g, idx, *rank)
                    for g in range(self.G)]
            for name, st in zip(self.member_names,
                                self.run_param(param, gens)):
                results[name][param] = st
        self.log.info("Done!")
        return results

