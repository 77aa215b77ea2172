"""Iteration-cap sweep runner: every max_iter variant in one decode pass
(counterpart of ``ldpc_decoders_tpu.harness.cap_sweep``).

The reference's REG_BAD campaign re-runs the whole Monte-Carlo once per
iteration cap (caps {0,1,2,3,6,10,40,100} x 5 sweeps). A BP word's
trajectory does not depend on the cap, so ``decode_multi_cap`` snapshots
the decisions at every cap in one pass (the kernels' ``caps=`` planes) and
this runner Monte-Carlos all caps at once: per-cap tallies, termination
once every cap has ``min_wec`` word errors, and one Saver per cap writing
the file a per-cap ``MonteCarloRunner`` would write. Per-cap estimates
share noise realizations (correlated across caps, unbiased individually).

max_iter label semantics (calibrated on the committed goldens):
- label > 0: that iteration cap;
- label = 0: NO decoding — the tally scores the raw channel output, as
  the goldens' vintage did: bec/bsc tally ``y != x`` (erasures are
  errors); on biawgn the real-valued y never equals a bit, so every bit
  scores as an error (WER = BER = 1);
- label < 0: run to convergence, bounded by ``iter_cap``.

One route per device: the kernel on CUDA, the plain version on the CPU. A
kernel that fails raises; there is no probe and no fallback.

With a ``mesh`` (a ``batch`` axis only) the sweep fans out as
``MonteCarloRunner`` does: rank r of N decodes ``batch / N`` words a chunk
from its own generator, the per-cap tallies are summed over the ranks
(``Mesh.device_tally``), every rank stops on the same sums, and only rank
0 writes. One rank draws the stream of a run without a mesh.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict, deque
from typing import Sequence

import numpy as np
import torch

from ldpc_decoders_tpu_torch.decoders.bec_spa import BECSPADecoder
from ldpc_decoders_tpu_torch.decoders.bp import BPDecoder
from ldpc_decoders_tpu_torch.harness.runner import MonteCarloRunner, RunConfig
from ldpc_decoders_tpu_torch.harness.saver import Saver
from ldpc_decoders_tpu_torch.ops import chunk_kernel
from ldpc_decoders_tpu_torch.parallel.mesh import is_coordinator


class CapSweepRunner(MonteCarloRunner):
    """One (channel, code, decoder) sweep tallied at several iteration
    caps at once. ``cap_labels`` are max_iter values as the reference
    spells them; the decode runs once to the largest effective cap. BP
    decoders only (SPA/MSA, the ternary SPA on bec)."""

    def __init__(self, cfg: RunConfig, cap_labels: Sequence[int],
                 mesh=None):
        if cfg.decoder not in ("SPA", "MSA"):
            raise ValueError("cap sweep supports BP decoders only")
        if mesh is not None and "code" in mesh.axis_names:
            raise ValueError("the cap sweep shards its batch only; a mesh "
                             "with a code axis does not apply")
        self.cap_labels = list(cap_labels)
        # label 0 = raw channel output (slot 0 of the tally, no decode);
        # label < 0 = converge (iter_cap); label > 0 = that cap.
        effective = [0 if c == 0 else (c if c > 0 else cfg.iter_cap)
                     for c in self.cap_labels]
        self.order = np.argsort(effective, kind="stable")  # ascending caps
        self.caps = [int(effective[i]) for i in self.order
                     if effective[i] > 0]
        self.n_zero = sum(1 for e in effective if e == 0)
        if self.n_zero > 1:
            raise ValueError("at most one raw-output (0) cap label")
        if len(set(self.caps)) != len(self.caps):
            raise ValueError(f"duplicate effective caps: {self.caps}")
        if not self.caps:
            raise ValueError("need at least one decoding cap label")
        self.K = self.n_zero + len(self.caps)

        super().__init__(cfg, mesh=mesh)

    def _make_decoder(self):
        cfg = self.cfg
        kw = dict(cfg.decoder_kwargs(), max_iter=self.caps[-1])
        if cfg.channel == "bec":
            return BECSPADecoder(self.code.graph, **kw)
        return BPDecoder(self.code.graph, cfg.decoder,
                         check_init=(cfg.channel != "biawgn"), **kw)

    def _make_savers(self) -> None:
        """One Saver per label, named as a per-cap ``MonteCarloRunner``
        would name it, in ascending-cap (tally) order."""
        cfg = self.cfg
        self.log = logging.getLogger(".".join(
            [cfg.channel, cfg.code, cfg.decoder, "caps"]))
        self.savers = []
        if cfg.data_dir and is_coordinator():
            for lbl_idx in self.order:
                ids = [("channel", cfg.channel), ("code", cfg.code),
                       ("decoder", cfg.decoder), ("codeword", cfg.codeword),
                       ("min_wec", cfg.min_wec),
                       ("max_iter", self.cap_labels[lbl_idx])]
                self.savers.append(Saver(cfg.data_dir, ids))

    def _chunk(self, param, gen: torch.Generator) -> torch.Tensor:
        """One super-batch -> the packed ``[2, K]`` tally (word errors and
        bit errors per cap, ascending caps), on device. Label 0 tallies the
        channel symbols on the BEC and BSC, and every bit on biAWGN."""
        cfg = self.cfg
        raw = self.n_zero and cfg.channel != "biawgn"
        if cfg.channel == "bec":
            idx, y = self._transmit(param, gen, "sym")
            soft = y
        elif raw:
            idx, (y, soft) = self._transmit(param, gen, "both")
        else:
            idx, soft = self._transmit(param, gen, "llr")
        x_hats, _ = self.dec.decode_multi_cap(soft, self.caps)
        return chunk_kernel.tally(
            x_hats, cfg.codeword, idx, self._cb, raw=y if raw else None,
            all_wrong=bool(self.n_zero) and not raw)

    def run_param(self, param: float, gen: torch.Generator) -> list:
        cfg = self.cfg
        tot = 0
        wec = np.zeros(self.K, np.int64)
        bec = np.zeros(self.K, np.int64)
        t_start = t_log = time.time()
        t_warm = None
        tot_warm = 0

        def cap_status(k) -> OrderedDict:
            wer = wec[k] / tot if tot else 0.0
            ber = bec[k] / (tot * self.code.get_n()) if tot else 0.0
            vals = OrderedDict([("tot", int(tot)), ("wec", int(wec[k])),
                                ("wer", float(wer)), ("bec", int(bec[k])),
                                ("ber", float(ber))])
            if t_warm is not None and tot > tot_warm:
                wps = (tot - tot_warm) / (time.time() - t_warm)
            else:
                elapsed = time.time() - t_start
                wps = tot / elapsed if elapsed > 0 else 0.0
            vals["words_per_sec"] = float(wps)
            return vals

        def log_and_save():
            self.log.info("TOT:%d (x%d caps), WEC:[%d..%d]",
                          tot, self.K, wec.min(), wec.max())
            for k, saver in enumerate(self.savers):
                saver.add(param, cap_status(k))

        pending: deque = deque()
        depth = max(1, int(cfg.pipeline))

        def consume():
            nonlocal tot, t_warm, tot_warm
            host, event = pending.popleft()
            if event is not None:
                event.synchronize()
            if self.mesh is not None and not self._device_sum:
                self.mesh.host_sum(host, "batch")
            arr = host.numpy().astype(np.int64)
            wec[:] += arr[0]
            bec[:] += arr[1]
            tot += cfg.batch
            if t_warm is None:
                t_warm = time.time()
                tot_warm = tot

        # Larger caps can only have fewer errors, so the largest cap is
        # the last to cross min_wec; still check all (ties at saturation).
        while (wec < cfg.min_wec).any():
            pending.append(self._dispatch(param, gen))
            if len(pending) >= depth:
                consume()
            if time.time() - t_log > cfg.log_freq:
                t_log = time.time()
                log_and_save()
            if cfg.max_words and tot + cfg.batch * len(pending) >= cfg.max_words:
                self.log.warning("max_words cap hit at %d", tot)
                break
        # Drain in-flight chunks: their inclusion is outcome-independent.
        while pending:
            consume()

        log_and_save()
        return [cap_status(k) for k in range(self.K)]

    def run(self) -> dict:
        """Full sweep. Returns {cap_label: {param: metrics}} (labels in
        the caller's original order)."""
        results = {lbl: {} for lbl in self.cap_labels}
        for idx, param in enumerate(self.cfg.params):
            self.log.info("Starting parameter: %f (K=%d caps)", param, self.K)
            stats = self.run_param(param, self._generator(idx))
            for k, lbl_idx in enumerate(self.order):
                results[self.cap_labels[lbl_idx]][param] = stats[k]
        self.log.info("Done!")
        return results
