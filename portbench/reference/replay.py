"""A sweep point replayed from the seed: the chunks the runner would draw,
decoded by the plain reference, consumed under the runner's rules:

- chunk k draws its noise (B x V) from the point's generator at dispatch,
  in dispatch order; every dispatched chunk is consumed, and the tallies
  count in consume order;
- after each dispatch the host consumes while the chunks in flight reach
  the pipeline's depth: 1, 2, 4, ... up to ``pipeline``, and, once every
  consumed chunk has seen errors, at most the chunks that the consumed
  rate says are still needed to reach ``min_wec``;
- dispatch stops once the consumed word errors reach ``min_wec``, or once
  the words consumed and in flight reach ``max_words``;
- a chunk's tally: words with any bit wrong (wec), wrong bits (bec), and
  the histogram of iteration counts in 2000 bins (the last one takes every
  count above it).

On several ranks along the batch, each rank replays its own stream at its
share of the batch (``rank_batch``), and at each consume the chunk's tally
is summed over the ranks (``host_sum``) before it counts: every rank then
takes the same stop and pipeline decisions from the same sums, and ``tot``
counts the whole batch.

When the host first waits on a chunk, every chunk dispatched by then is
drawn, in order, and decoded in one batch: the reference decodes what the
runner has in flight, and nothing that the point never consumes.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from portbench.reference import channels

HIST_LEN = 2000


def pipeline_depth(tick: int, depth: int, wec: int, chunks: int,
                   min_wec: int) -> int:
    eff = min(depth, 1 << min(tick - 1, 10))
    if wec < min_wec and wec > 0:
        eff = min(eff, max(1, math.ceil((min_wec - wec) * chunks / wec)))
    return eff


def tally(x_hat: torch.Tensor, codeword: int,
          iters: Optional[torch.Tensor]) -> np.ndarray:
    errs = (x_hat != codeword).sum(dim=-1)
    out = [int((errs > 0).sum()), int(errs.sum())]
    if iters is None:
        return np.array(out, dtype=np.int64)
    hist = torch.bincount(iters.clamp(0, HIST_LEN - 1).long(),
                          minlength=HIST_LEN)
    return np.concatenate([out, hist.cpu().numpy()]).astype(np.int64)


def replay_point(*, channel: str, codeword: int, param: float, batch: int,
                 n_var: int, gen: torch.Generator, decode: Callable,
                 min_wec: int, max_words: Optional[int], pipeline: int,
                 adaptive: bool, track_hist: bool,
                 rank_batch: Optional[int] = None,
                 host_sum: Optional[Callable] = None) -> dict:
    """The point's ``tot``, ``wec``, ``bec`` (and ``hist``), summed over
    the ranks, with its ``chunks`` and, for the work counts of this rank's
    words, ``iters_sum`` (the consumed chunks' iteration counts summed)
    and ``tail_words`` / ``tail_iters`` (the words whose count falls in the
    histogram's last bin, and their counts summed). ``decode(llr)`` ->
    (x_hat, iters)."""
    device = gen.device
    rank_batch = rank_batch or batch
    ready: list = []                # (tally, iterations) decoded ahead

    def chunk_tally(k: int) -> tuple:
        if len(ready) <= k:
            block = dispatched - len(ready)
            llr = torch.cat([
                channels.llr(channel, codeword,
                             channels.draw(channel, (rank_batch, n_var), gen,
                                           device), param)
                for _ in range(block)])
            x_hat, iters = decode(llr)
            for j in range(block):
                sl = slice(j * rank_batch, (j + 1) * rank_batch)
                tail = iters[sl] >= HIST_LEN - 1
                ready.append((tally(x_hat[sl], codeword,
                                    iters[sl] if track_hist else None),
                              int(iters[sl].sum()), int(tail.sum()),
                              int(iters[sl][tail].sum())))
        return ready[k]

    tot = wec = bec = iters_sum = tail_words = tail_iters = 0
    hist = np.zeros(HIST_LEN, dtype=np.int64)
    dispatched = consumed = 0

    def consume():
        nonlocal tot, wec, bec, hist, consumed, iters_sum, tail_words, \
            tail_iters
        t, n_iters, n_tail, tail_sum = chunk_tally(consumed)
        if host_sum is not None:
            t = host_sum(t)
        consumed += 1
        wec += int(t[0])
        bec += int(t[1])
        tot += batch
        iters_sum += n_iters
        tail_words += n_tail
        tail_iters += tail_sum
        if track_hist:
            hist += t[2:]

    while wec < min_wec:
        dispatched += 1
        while dispatched - consumed >= (
                pipeline_depth(dispatched, pipeline, wec, consumed, min_wec)
                if adaptive else pipeline):
            consume()
        if max_words and tot + batch * (dispatched - consumed) >= max_words:
            break
    while consumed < dispatched:
        consume()
    out = {"tot": tot, "wec": wec, "bec": bec, "chunks": consumed,
           "iters_sum": iters_sum, "tail_words": tail_words,
           "tail_iters": tail_iters}
    if track_hist:
        out["hist"] = hist
    return out
