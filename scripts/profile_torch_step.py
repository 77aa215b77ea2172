"""Where the time of the port's Monte-Carlo step goes, on one CUDA device.

    python scripts/profile_torch_step.py [--step msa|bec|caps|admm|admm_mar]
        [--batch 16384] [--out report.json]
    python scripts/profile_torch_step.py --campaign REG_BAD [--out report.json]

The step, on LDPC(1200,3,6) unless it names another code:

- ``msa`` (default): biAWGN min-sum bf16 at 2.5 and 3.0 dB;
- ``bec``: the erasure step (BEC, ternary erasure SPA, cap 10) at p=0.375
  and 0.4;
- ``caps``: the multi-cap step of the iteration-cap sweep (biAWGN min-sum
  bf16 at 2.0 dB, REG_BAD's labels 0,1,2,3,6,10,40,100 from one decode);
- ``admm``: ADMM LP decoding, biAWGN at 2.5 dB, at most 50 iterations;
- ``admm_mar``: ADMM on margulis in converge mode (bound 8000), BSC at
  p=0.07 and 0.06, the MAR goldens' configuration (use ``--batch 2048``).

For each point:

1. ``torch.profiler`` over a steady window of the runner's chunk (sample
   -> LLR -> decode -> tally): device time by kernel, and the device's
   busy share of the window's wall time;
2. the runner end to end (one packed tally per chunk): ``words_per_sec``
   over a fixed number of words;
3. the decode kernel alone (CUDA events, two runs of 20 decodes) at the
   launch geometry its wrapper picks for the graph, which is reported
   (other geometries: ``scripts/sweep_admm_geometry.py``,
   ``scripts/profile_bp_kernel.py``).

With ``--campaign`` the script instead runs that whole campaign case once
(``campaign.run_campaign``, its own batch and ``min_wec``) after building
the kernels, and prints its wall time and, for every Saver file that has a
committed golden of the same name in ``artifacts/data``, the z-score
(Agresti-Coull) of each sweep point's WER against the golden's.

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ldpc_decoders_tpu_torch import campaign  # noqa: E402
from ldpc_decoders_tpu_torch.channels import CHANNELS  # noqa: E402
from ldpc_decoders_tpu_torch.harness import (  # noqa: E402
    CapSweepRunner,
    MonteCarloRunner,
    RunConfig,
)
from ldpc_decoders_tpu_torch.ops import (  # noqa: E402
    _build,
    admm_kernel,
    bec_kernel,
    msa_kernel,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "artifacts", "data")

_MSA = dict(channel="biawgn", decoder="MSA", codeword=1, msg_dtype="bfloat16")
# step -> (RunConfig fields, sweep points, cap labels or None)
STEPS = {
    "msa": (_MSA, (2.5, 3.0), None),
    "bec": (dict(channel="bec", decoder="SPA", codeword=0), (0.375, 0.4),
            None),
    "caps": (_MSA, (2.0,), [0, 1, 2, 3, 6, 10, 40, 100]),
    "admm": (dict(channel="biawgn", decoder="ADMM", codeword=1, max_iter=50),
             (2.5,), None),
    "admm_mar": (dict(channel="bsc", decoder="ADMM", codeword=1, max_iter=0,
                      iter_cap=8000, code="margulis"), (0.07, 0.06), None),
}


def launch_geometry(step: str, g):
    """The geometry the step's kernel wrapper picks for graph ``g`` (the
    min-sum steps run bf16 messages)."""
    if step.startswith("admm"):
        return admm_kernel.admm_geometry(g.n_chk, g.n_var, g.max_chk_deg)
    dims = (g.n_chk, g.n_var, g.max_chk_deg, g.max_var_deg)
    if step == "bec":
        return bec_kernel.bec_geometry(*dims)
    return msa_kernel.msa_geometry(*dims, True)


def ac_var(w: float, t: int) -> float:
    """Agresti-Coull adjusted binomial variance of an observed rate."""
    p = (w * t + 2.0) / (t + 4.0)
    return p * (1.0 - p) / (t + 4.0)


def campaign_report(case: str, card: str) -> dict:
    """Run campaign ``case`` once; wall time and z per Saver file and sweep
    point against the golden of the same name."""
    t0 = time.perf_counter()
    for src in ("msa_decode", "spa_decode", "bec_decode", "admm_decode"):
        _build.load_library(src)
    build_s = time.perf_counter() - t0
    report = {"card": card, "campaign": case, "build_s": build_s, "files": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        runs = campaign.run_campaign([case], data_dir=tmp)
        torch.cuda.synchronize()
        report["wall_s"] = time.perf_counter() - t0
        report["runs"] = len(runs)
        print(f"campaign {case}: {len(runs)} runs, {len(os.listdir(tmp))} "
              f"Saver files in {report['wall_s']:.3f} s (kernel build "
              f"{build_s:.1f} s before it) | {card}")
        for name in sorted(os.listdir(tmp)):
            golden = os.path.join(ARTIFACTS, name)
            if not os.path.exists(golden):
                report["files"][name] = None
                print(f"  {name}: no golden")
                continue
            with open(os.path.join(tmp, name)) as fp:
                saved = json.load(fp)
            with open(golden) as fp:
                ref = json.load(fp)
            zs = {}
            for key in saved["wer"]:
                if key not in ref["wer"]:
                    continue
                var = (ac_var(saved["wer"][key], saved["tot"][key])
                       + ac_var(ref["wer"][key], ref["tot"][key]))
                zs[key] = (saved["wer"][key] - ref["wer"][key]) / math.sqrt(var)
            report["files"][name] = zs
            worst = max(zs, key=lambda k: abs(zs[k])) if zs else None
            over = [f"{k}: {saved['wer'][k]:.5f} vs {ref['wer'][k]:.5f}"
                    for k in sorted(zs) if abs(zs[k]) > 4.0]
            print(f"  {name}: {len(zs)} points, max |z| "
                  f"{abs(zs[worst]) if zs else float('nan'):.3f} at {worst}, "
                  f"|z| > 4 (WER vs golden) at {over}")
    return report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--campaign", choices=sorted(campaign.all_cases.keys()),
                    default=None, help="run this campaign case against the "
                                       "goldens instead of profiling a step")
    ap.add_argument("--step", choices=sorted(STEPS), default="msa")
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--chunks", type=int, default=40)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    if args.campaign:
        write_report(campaign_report(args.campaign, card), args.out)
        return
    report = {"card": card, "step": args.step, "batch": args.batch,
              "points": {}}
    B = args.batch
    cfg_kw, points, labels = STEPS[args.step]
    cfg_kw = dict({"code": "1200_3_6_ldpc"}, **cfg_kw)
    unit = "dB" if cfg_kw["channel"] == "biawgn" else "p"
    for snr in points:
        cfg = RunConfig(params=[snr],
                        min_wec=10 ** 12, batch=B, max_words=B * args.chunks,
                        device="cuda", log_freq=1e9, **cfg_kw)
        runner = (CapSweepRunner(cfg, labels) if labels
                  else MonteCarloRunner(cfg))
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
        print(f"{snr} {unit} profile: step {step_ms:.4f} ms, device busy "
              f"{busy:.4f} ms ({100 * busy / step_ms:.1f}%) | {card}")
        for k, ms, c in rows[:12]:
            print(f"    {ms:9.4f} ms  x{c:<3d} {k[:90]}")

        res = runner.run()
        # A cap sweep reports per label: take the largest cap's line.
        res = res[max(labels)][snr] if labels else res[snr]
        point["runner"] = dict(res)
        print(f"{snr} {unit} runner: {res['tot']} words, wer "
              f"{res['wer']:.6f}, {res['words_per_sec']:.1f} cw/s | {card}")

        mod = CHANNELS[cfg.channel]
        x = torch.full((B, runner.code.get_n()), cfg.codeword,
                       dtype=torch.int32, device="cuda")
        y = mod.send(x, snr, gen)
        inp = y if cfg.channel == "bec" else mod.llr(y, snr)
        if labels:
            def decode():
                runner.dec.decode_multi_cap(inp, runner.caps)
        else:
            decode = lambda: runner.dec.dec.decode(inp)  # noqa: E731
        geo = launch_geometry(args.step, runner.code.graph)
        point["geometry"] = geo._asdict()
        print(f"{snr} {unit} launch geometry: {geo} | {card}")
        decode_ms = []
        decode()
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                decode()
            stop.record()
            torch.cuda.synchronize()
            decode_ms.append(start.elapsed_time(stop) / 20)
        point["decode_ms"] = decode_ms
        print(f"{snr} {unit} decode ms: {decode_ms} | {card}")
        report["points"][str(snr)] = point

    write_report(report, args.out)


def write_report(report: dict, out) -> None:
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as fp:
            json.dump(report, fp, indent=1)


if __name__ == "__main__":
    main()
