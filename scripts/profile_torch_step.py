"""Where the time of the port's Monte-Carlo step goes, on one CUDA device.

    python scripts/profile_torch_step.py [--step msa|bec|caps|admm|admm_mar]
        [--batch 16384] [--out report.json] [--saver DIR]
    python scripts/profile_torch_step.py --campaign REG_BAD [--out report.json]
        [--max-words N] [--joint-ensemble]

The step, on LDPC(1200,3,6) unless it names another code:

- ``msa`` (default): biAWGN min-sum bf16 at 2.5 and 3.0 dB;
- ``bec``: the erasure step (BEC, ternary erasure SPA, cap 10) at p=0.375
  and 0.4;
- ``caps``: the multi-cap step of the iteration-cap sweep (biAWGN min-sum
  bf16 at 2.0 dB, REG_BAD's labels 0,1,2,3,6,10,40,100 from one decode);
- ``admm``: ADMM LP decoding, biAWGN at 2.5 dB, at most 50 iterations;
- ``admm_mar``: ADMM on margulis in converge mode (bound 8000), BSC at
  p=0.07 and 0.06, the MAR goldens' configuration (use ``--batch 2048``).

``--step`` takes several steps, comma-separated (``msa,bec,caps,admm``),
run one after the other in one process. For each point:

1. ``torch.profiler`` over a steady window of the runner's dispatch (the
   chunk: sample -> LLR -> decode -> tally, and the tally's copy to pinned
   host memory): device time by kernel, and the device's busy share of the
   window's wall time. The kernels are then split three ways: the decode
   kernel(s), the port's other hand-written kernels around it (the
   ``__global__`` functions of ``csrc/chunk.cu``), and every PyTorch launch
   around it (copies and fills included), each of these by name with its
   device ms and launches per chunk;
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
(Agresti-Coull) of each sweep point's WER against the golden's, and the
largest |z| of each leg (the files of one channel and decoder).
``--max-words`` bounds the words of each sweep point (the ensemble goldens
were made with 1500000: deep points of REG_ENS's BSC min-sum leg see no
error in that many); ``--joint-ensemble`` runs the ensemble cases through
the joint route.

With ``--saver DIR`` the script first runs the flagship CLI run of
``chip_smoke.py``'s phase 4 (``main biawgn 1200_3_6_ldpc MSA --params 2.5
--codeword 1 --min-wec 200 --bf16 --batch 16384``, seed 0) into ``DIR`` and
prints its Saver file's ``tot``, ``wec`` and ``bec``: two trees that draw
and decode alike print the same numbers.

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import glob
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ldpc_decoders_tpu_torch import campaign  # noqa: E402
from ldpc_decoders_tpu_torch import main as cli  # noqa: E402
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


FLAGSHIP_ARGV = ["biawgn", "1200_3_6_ldpc", "MSA", "--params", "2.5",
                 "--codeword", "1", "--min-wec", "200", "--bf16", "--batch",
                 "16384"]


def port_kernels() -> tuple:
    """(decode kernels, kernels around the decode): the names of the
    ``__global__`` functions of the port's sources, those of
    ``csrc/chunk.cu`` (C1, C2) apart."""
    names = {}
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__"
                         r"\([^)]*\)\s*)?(\w+)\s*\(")
    for path in glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")):
        with open(path) as fp:
            for name in pattern.findall(fp.read()):
                names[name] = os.path.basename(path)
    around = {k for k, src in names.items() if src == "chunk.cu"}
    return set(names) - around, around


def kernel_class(key: str, decode: set, around: set) -> str:
    """"decode", "around" (a hand-written kernel of the chunk) or
    "pytorch" (any other launch: PyTorch's kernels, copies, fills)."""
    words = set(re.findall(r"\w+", key))
    if words & decode:
        return "decode"
    return "around" if words & around else "pytorch"


def flagship_saver(out_dir: str, card: str) -> dict:
    """Phase 4's flagship CLI run into ``out_dir``: its Saver file's tot,
    wec and bec."""
    cli.main(FLAGSHIP_ARGV + ["--console", "--data_dir", out_dir])
    path, = glob.glob(os.path.join(out_dir, "*.json"))
    with open(path) as fp:
        saved = json.load(fp)
    got = {k: saved[k]["2.5"] for k in ("tot", "wec", "bec")}
    print(f"flagship Saver file {os.path.basename(path)}: tot {got['tot']} "
          f"wec {got['wec']} bec {got['bec']} | {card}")
    return got


def ac_var(w: float, t: int) -> float:
    """Agresti-Coull adjusted binomial variance of an observed rate."""
    p = (w * t + 2.0) / (t + 4.0)
    return p * (1.0 - p) / (t + 4.0)


def campaign_report(case: str, card: str, max_words=None,
                    joint_ensemble: bool = False) -> dict:
    """Run campaign ``case`` once; wall time and z per Saver file and sweep
    point against the golden of the same name, and max |z| per leg."""
    t0 = time.perf_counter()
    for src in ("msa_decode", "spa_decode", "bec_decode", "admm_decode"):
        _build.load_library(src)
    build_s = time.perf_counter() - t0
    report = {"card": card, "campaign": case, "build_s": build_s, "files": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        runs = campaign.run_campaign(
            [case], data_dir=tmp, joint_ensemble=joint_ensemble,
            overrides={"max_words": max_words} if max_words else None)
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
    legs = {}
    for name, zs in report["files"].items():
        channel, decoder = name.split("-")[0], name.split("-")[2]
        legs.setdefault(f"{channel} {decoder}", []).extend(
            abs(z) for z in (zs or {}).values())
    report["max_abs_z_by_leg"] = {k: max(v) for k, v in legs.items() if v}
    print(f"campaign {case}: max |z| by leg {report['max_abs_z_by_leg']} | "
          f"{card}")
    return report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--campaign", choices=sorted(campaign.all_cases.keys()),
                    default=None, help="run this campaign case against the "
                                       "goldens instead of profiling a step")
    ap.add_argument("--max-words", type=int, default=None,
                    help="with --campaign: words per sweep point at most")
    ap.add_argument("--joint-ensemble", action="store_true",
                    help="with --campaign: the joint ensemble route")
    ap.add_argument("--step", default="msa",
                    help=f"one or more of {sorted(STEPS)}, comma-separated")
    ap.add_argument("--saver", default=None,
                    help="first run phase 4's flagship CLI run into this "
                         "directory and print its tot, wec, bec")
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--chunks", type=int, default=40)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args()
    steps = args.step.split(",")
    if not set(steps) <= set(STEPS):
        ap.error(f"--step: {steps} not all in {sorted(STEPS)}")
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    if args.campaign:
        write_report(campaign_report(args.campaign, card, args.max_words,
                                     args.joint_ensemble), args.out)
        return
    report = {"card": card, "batch": args.batch, "steps": {}}
    if args.saver:
        report["flagship_saver"] = flagship_saver(args.saver, card)
    for step in steps:
        report["steps"][step] = profile_step(step, args.batch, args.chunks,
                                             card)
    write_report(report, args.out)


def profile_step(step: str, B: int, n_chunks: int, card: str) -> dict:
    """The step's profile, runner rate and decode time at each of its
    points."""
    decode_names, around_names = port_kernels()
    report = {"points": {}}
    cfg_kw, points, labels = STEPS[step]
    cfg_kw = dict({"code": "1200_3_6_ldpc"}, **cfg_kw)
    unit = "dB" if cfg_kw["channel"] == "biawgn" else "p"
    for snr in points:
        cfg = RunConfig(params=[snr],
                        min_wec=10 ** 12, batch=B, max_words=B * n_chunks,
                        device="cuda", log_freq=1e9, **cfg_kw)
        runner = (CapSweepRunner(cfg, labels) if labels
                  else MonteCarloRunner(cfg))
        gen = runner._generator(0)
        for _ in range(3):
            runner._dispatch(snr, gen)
        torch.cuda.synchronize()

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        n = 10
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            tallies = [runner._dispatch(snr, gen) for _ in range(n)]
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
                              "calls_per_step": c,
                              "class": kernel_class(k, decode_names,
                                                    around_names)}
                             for k, ms, c in rows]}
        print(f"{step} {snr} {unit} profile: step {step_ms:.4f} ms, device "
              f"busy {busy:.4f} ms ({100 * busy / step_ms:.1f}%) | {card}")
        for cls, title in (("decode", "the decode"),
                           ("around", "hand-written kernels around it"),
                           ("pytorch", "PyTorch launches around it")):
            mine = [r for r in point["kernels"] if r["class"] == cls]
            ms = sum(r["ms_per_step"] for r in mine)
            calls = sum(r["calls_per_step"] for r in mine)
            point.setdefault("by_class", {})[cls] = {"ms": ms,
                                                     "launches": calls}
            print(f"  {title}: {ms:.4f} ms in {calls} launches per chunk")
            for r in mine:
                print(f"    {r['ms_per_step']:9.4f} ms  "
                      f"x{r['calls_per_step']:<3d} {r['name']}")

        res = runner.run()
        # A cap sweep reports per label: take the largest cap's line.
        res = res[max(labels)][snr] if labels else res[snr]
        point["runner"] = dict(res)
        print(f"{step} {snr} {unit} runner: {res['tot']} words, wer "
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
        geo = launch_geometry(step, runner.code.graph)
        point["geometry"] = geo._asdict()
        print(f"{step} {snr} {unit} launch geometry: {geo} | {card}")
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
        print(f"{step} {snr} {unit} decode ms: {decode_ms} | {card}")
        report["points"][str(snr)] = point
    return report


def write_report(report: dict, out) -> None:
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as fp:
            json.dump(report, fp, indent=1)


if __name__ == "__main__":
    main()
