"""Where the time of the port's Monte-Carlo step goes, on one CUDA device.

    python scripts/profile_torch_step.py [--batch 16384] [--out report.json]

For biAWGN LDPC(1200,3,6) MSA bf16 at 2.5 and 3.0 dB:

1. ``torch.profiler`` over a steady window of the runner's chunk (sample
   -> LLR -> decode -> tally): device time by kernel, and the device's
   busy share of the window's wall time;
2. the runner end to end (adaptive pipeline, one packed tally per chunk):
   ``words_per_sec`` over a fixed number of words;
3. the decode kernel alone (CUDA events) at 128, 256 and 512 threads per
   codeword.

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ldpc_decoders_tpu_torch.channels import biawgn  # noqa: E402
from ldpc_decoders_tpu_torch.harness import MonteCarloRunner, RunConfig  # noqa: E402
from ldpc_decoders_tpu_torch.ops import msa_kernel  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--chunks", type=int, default=40)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    report = {"card": card, "batch": args.batch, "points": {}}
    B = args.batch
    for snr in (2.5, 3.0):
        cfg = RunConfig(channel="biawgn", code="1200_3_6_ldpc",
                        decoder="MSA", params=[snr], codeword=1,
                        min_wec=10 ** 12, batch=B, max_words=B * args.chunks,
                        msg_dtype="bfloat16", device="cuda", log_freq=1e9)
        runner = MonteCarloRunner(cfg)
        gen = runner._generator(0)
        for _ in range(3):
            runner._chunk(snr, gen)
        torch.cuda.synchronize()

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        n = 10
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            tallies = [runner._chunk(snr, gen) for _ in range(n)]
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        del tallies
        rows = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
            if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
                rows.append((ev.key, dev_us / 1e3 / n, ev.count // n))
        rows.sort(key=lambda r: -r[1])
        if not rows:
            print(prof.key_averages().table(row_limit=20))
        busy = sum(r[1] for r in rows)
        step_ms = wall_ms / n
        point = {"step_ms": step_ms, "device_busy_ms": busy,
                 "idle_share": max(0.0, 1.0 - busy / step_ms),
                 "kernels": [{"name": k[:90], "ms_per_step": ms,
                              "calls_per_step": c} for k, ms, c in rows]}
        print(f"{snr} dB profile: step {step_ms:.4f} ms, device busy "
              f"{busy:.4f} ms ({100 * busy / step_ms:.1f}%) | {card}")
        for k, ms, c in rows[:12]:
            print(f"    {ms:9.4f} ms  x{c:<3d} {k[:90]}")

        res = runner.run()[snr]
        point["runner"] = dict(res)
        print(f"{snr} dB runner: {res['tot']} words, wer {res['wer']:.6f}, "
              f"{res['words_per_sec']:.1f} cw/s | {card}")

        dec = runner.dec.dec  # the BPDecoder behind the channel adapter
        x = torch.ones((B, 1200), dtype=torch.int32, device="cuda")
        llr = biawgn.llr(biawgn.send(x, snr, gen), snr)
        threads = {}
        for th in (128, 256, 512, 256, 128):
            msa_kernel.THREADS = th
            dec.decode(llr)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                dec.decode(llr)
            stop.record()
            torch.cuda.synchronize()
            threads.setdefault(th, []).append(start.elapsed_time(stop) / 20)
        msa_kernel.THREADS = 256
        point["decode_ms_by_threads"] = threads
        print(f"{snr} dB decode ms by threads/CTA: "
              + ", ".join(f"{k}: {v}" for k, v in threads.items())
              + f" | {card}")
        report["points"][str(snr)] = point

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(report, fp, indent=1)


if __name__ == "__main__":
    main()
