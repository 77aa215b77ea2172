"""The LT peel kernel on one CUDA device: held against the plain version
and its own tables against ``edge_layout``, then timed per batch, by the
number of warps that take ripple symbols, beside an earlier commit's copy
of the kernel.

    python scripts/profile_lt_kernel.py [--cs 0.01,0.03,0.1] [--batch 64]
        [--warps 16,24,32] [--parent DIR] [--plain] [--reps 5]
        [--out report.json]

Inputs: the golden curves' configuration (k=10000, n=12000, delta=0.5),
one batch per c drawn with ``LTSimulator.sample_batch`` from seed 8 + its
index; also (k, n) = (40, 46) and (60, 120) at c=0.1, and (10000, 28743)
at c=0.03, the largest n the kernel's first form took at k=10000, whose
symbol words and offsets do not fit in shared memory.

``--parent DIR`` is an unpacked tree of an earlier commit (``git archive``):
its ``ops/lt_kernel.py`` is loaded beside this one and its
``csrc/lt_peel.cu`` built from DIR, and its ``lt_peel_cuda`` (edge layout
included) is timed in turns with this tree's: parent, change, change,
parent; the two must agree in ``result``, ``resolved`` and ``est`` where
resolved. With ``--plain`` both are also held to ``lt_peel_plain``.

Per c: the kernel's ms with its layout at each ``--warps`` count (CUDA
events, best of ``--reps`` launches after a warm-up), the layout alone
(``lt_layout_cuda``), the peel (the difference), the parent's ms and its
layout alone (``edge_layout`` and the gather), the ripples of the slowest
sim and the real edges. Every line carries the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ldpc_decoders_tpu_torch.fountain import lt  # noqa: E402
from ldpc_decoders_tpu_torch.ops import lt_kernel  # noqa: E402

K, N, DELTA = 10000, 12000, 0.5
KEYS = ("edge_sym", "edge_var", "msg")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return out[0] if out else torch.cuda.get_device_name(0)


def load_parent(root: str):
    """The parent's ``ops/lt_kernel.py``, its library built from its own
    ``csrc/lt_peel.cu`` (through the parent's ``ops/_build.py``)."""
    pkg = os.path.join(root, "ldpc_decoders_tpu_torch", "ops")
    mods = {}
    for name in ("_build", "lt_kernel"):
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}", os.path.join(pkg, f"{name}.py"))
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    mods["lt_kernel"].load_library = mods["_build"].load_library
    return mods["lt_kernel"]


def differs(a, b) -> bool:
    return not (torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
                and torch.equal(a[1][a[2]], b[1][b[2]]))


def timed(fn, reps):
    """Best of ``reps`` single launches by CUDA events, after a warm-up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best, out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cs", default="0.01,0.03,0.1")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--warps", default="16,24,32")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_lt_kernel.py needs a CUDA device")
    dev = torch.device("cuda")
    card = card_line()
    warps = [int(x) for x in args.warps.split(",")]
    parent = load_parent(args.parent) if args.parent else None
    report = {"card": card, "cases": []}

    t0 = time.perf_counter()
    lt_kernel._kernel_library()
    if parent is not None:
        parent._kernel_library()
    print(f"build {time.perf_counter() - t0:.1f} s | {card}", flush=True)

    # Small cases, and one whose offset tables live in device memory.
    for k, n, c, sims in ((40, 46, 0.1, 24), (60, 120, 0.1, 24),
                          (10000, 28743, 0.03, 2)):
        sim = lt.LTSimulator(k, n, c, DELTA, device=dev)
        t = sim.sample_batch(np.random.default_rng(3), sims)
        a = [t[key].to(dev) for key in KEYS]
        out = lt_kernel.lt_peel_cuda(*a, n)
        tab = lt_kernel.lt_layout_cuda(*a, n)
        ok = (not differs(out, lt_kernel.lt_peel_plain(*a, n))
              and lt_kernel.layout_matches(tab, a[0], a[1], n))
        shared = lt_kernel.kernel_plan(*a, n)
        print(f"check k={k} n={n}: {'equal' if ok else 'DIFFERS'} (words "
              f"and offsets in {'shared' if shared else 'device'} memory; "
              f"failures "
              f"{int((out[0] == n).sum())}) | {card}", flush=True)
        if not ok:
            sys.exit(1)

    for i, c in enumerate(args.cs.split(",")):
        sim = lt.LTSimulator(K, N, float(c), DELTA, device=dev)
        t = sim.sample_batch(np.random.default_rng(8 + i), args.batch)
        a = [t[key].to(dev) for key in KEYS]
        edges = int((a[0] < N).sum())
        ref = lt_kernel.lt_peel_cuda(*a, N, peel_warps=warps[0])
        if not lt_kernel.layout_matches(lt_kernel.lt_layout_cuda(*a, N),
                                        a[0], a[1], N):
            sys.exit(f"kernel tables != edge_layout at c={c}")
        if args.plain and differs(ref, lt_kernel.lt_peel_plain(*a, N)):
            sys.exit(f"kernel != plain at c={c}")
        case = {"c": float(c), "batch": args.batch, "edges": edges,
                "ripples_max": int(ref[3].max()),
                "ripples_mean": float(ref[3].float().mean())}
        lay, _ = timed(lambda: lt_kernel.lt_layout_cuda(*a, N), args.reps)
        case["layout_ms"] = lay

        def new(w):
            ms, out = timed(lambda: lt_kernel.lt_peel_cuda(
                *a, N, peel_warps=w), args.reps)
            if differs(out, ref):
                sys.exit(f"kernel at {w} warps != at {warps[0]}, c={c}")
            return ms

        def old():
            ms, out = timed(lambda: parent.lt_peel_cuda(*a, N), args.reps)
            if differs(out, ref):
                sys.exit(f"parent kernel != this kernel at c={c}")
            return ms

        if parent is not None:
            case["parent_ms"] = [old()]
            case["parent_layout_ms"] = timed(
                lambda: a[0].gather(-1, parent.edge_layout(
                    a[0], a[1], N, K)[1]), args.reps)[0]
        case["ms"] = {w: [new(w)] for w in warps}
        for w in warps:
            case["ms"][w].append(new(w))
        if parent is not None:
            case["parent_ms"].append(old())
        best = min(case["ms"], key=lambda w: min(case["ms"][w]))
        line = ", ".join(f"{w} warps {' / '.join(f'{x:.4f}' for x in v)}"
                         for w, v in case["ms"].items())
        print(f"lt_peel c={c} B={args.batch}: {line} ms (best {best} warps: "
              f"layout {lay:.4f}, peel {min(case['ms'][best]) - lay:.4f}); "
              f"ripples max {case['ripples_max']} mean "
              f"{case['ripples_mean']:.1f}; {edges} edges | {card}",
              flush=True)
        if parent is not None:
            print(f"parent lt_peel c={c}: "
                  f"{' / '.join(f'{x:.4f}' for x in case['parent_ms'])} ms "
                  f"(its layout {case['parent_layout_ms']:.4f}) | {card}",
                  flush=True)
        report["cases"].append(case)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(report, fp, indent=1)


if __name__ == "__main__":
    main()
