"""The ADMM kernel's time by launch geometry, on one CUDA device.

    python scripts/sweep_admm_geometry.py [--input flagship|margulis|hamming|all]
        [--threads 128,256,...] [--seeds 3,4,...] [--clocks]
        [--out report.json]

Inputs (the timed inputs of ``chip_smoke.py``, codeword 1; seed 3 is that
script's batch, each further seed of ``--seeds`` another chunk of the same
channel, since a chunk's time on margulis depends on its words):

- ``flagship``: LDPC(1200,3,6), biAWGN 2.5 dB, at most 50 updates, B=16384;
- ``margulis``: BSC p=0.07 in converge mode (bound 8000), B=2048, and its
  first 128 words on their own (fewer words than the card has SMs: the
  time of the slowest word);
- ``hamming``: Hamming(7,4), BSC p=0.1, at most 50 updates, B=16384.

For each input: the iteration counts (mean, median, largest; on margulis
also over the first 128 words), then per thread count per word the decode
time by CUDA events, best of three, and whether the outputs equal those
of the rule's own thread count bit for bit (which ``chip_smoke.py`` holds
to the plain version).

``--clocks`` builds a copy of the kernel with ``clock64()`` readings around
the x-update, the z-update, the barriers and the final fold, and prints
their shares of an iteration, summed over thread 0 of every CTA.

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ldpc_decoders_tpu_torch.channels import CHANNELS  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.ops import _build, admm_kernel  # noqa: E402
from ldpc_decoders_tpu_torch.ops.graph import bp_tables  # noqa: E402

INPUTS = {
    "flagship": ("1200_3_6_ldpc", "biawgn", 2.5, 50, 16384),
    "margulis": ("margulis", "bsc", 0.07, 8000, 2048),
    "hamming": ("7_4_hamming", "bsc", 0.1, 50, 16384),
}
HEAD = 128
PHASES = ("x-update", "barrier 1", "z-update", "barrier 2", "fold")


def clocked_library() -> ctypes.CDLL:
    """A build of the kernel with five clock64() readings per iteration,
    summed over thread 0 of every CTA into ``g_clk``."""
    with open(os.path.join(_build.CSRC_DIR, "admm_decode.cu")) as fp:
        src = fp.read()

    def put(text, anchor, new, after=True, nth=0):
        at = -1
        for _ in range(nth + 1):
            at = text.index(anchor, at + 1)
        if after:
            at += len(anchor)
        return text[:at] + new + text[at:]

    src = put(src, "namespace {\n",
              "__device__ unsigned long long g_clk[5];\n")
    src = put(src, "    // x-update: slots in slot order",
              "    const long long c0 = clock64();\n", after=False)
    src = put(src, "    __syncthreads();\n\n    // z-update",
              "\n    const long long c1 = clock64();\n", after=False)
    src = put(src, "    __syncthreads();\n",
              "    const long long c2 = clock64();\n", nth=0)
    src = put(src, "    // Barrier: z, lam and the block sums complete",
              "    const long long c3 = clock64();\n", after=False)
    src = put(src, "    __syncthreads();\n",
              "    const long long c4 = clock64();\n", nth=1)
    src = put(src, "    fold_blocks(s_blk, nb, lane, tot);\n",
              "    if (tid == 0) {\n"
              "      const long long c5 = clock64();\n"
              "      atomicAdd(&g_clk[0], (unsigned long long)(c1 - c0));\n"
              "      atomicAdd(&g_clk[1], (unsigned long long)(c2 - c1));\n"
              "      atomicAdd(&g_clk[2], (unsigned long long)(c3 - c2));\n"
              "      atomicAdd(&g_clk[3], (unsigned long long)(c4 - c3));\n"
              "      atomicAdd(&g_clk[4], (unsigned long long)(c5 - c4));\n"
              "    }\n")
    src += ("\nextern \"C\" int admm_clocks(unsigned long long* out) {\n"
            "  cudaDeviceSynchronize();\n"
            "  cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n"
            "  unsigned long long zero[5] = {0, 0, 0, 0, 0};\n"
            "  return (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));\n"
            "}\n")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, "admm_decode_clocks.cu")
    so = os.path.join(_build.BUILD_DIR, "libadmm_decode_clocks.so")
    with open(cu, "w") as fp:
        fp.write(src)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_build._nvcc(), *flags, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed on the clocked copy:\n{proc.stderr}")
    return ctypes.CDLL(so)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="all",
                    choices=sorted(INPUTS) + ["all"])
    ap.add_argument("--threads", default="32,64,128,192,256,320,448,512,"
                                         "704,1024")
    ap.add_argument("--seeds", default="3")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    lib = admm_kernel._kernel_library()
    with open(_build.library_path("admm_decode") + ".log") as fp:
        regs = [ln for ln in fp.read().splitlines() if "registers" in ln]
    print(f"ptxas registers, min..max over {len(regs)} kernels: "
          f"{min(regs, key=_reg_count)} .. {max(regs, key=_reg_count)}")
    clocked = clocked_library() if args.clocks else None
    if clocked:
        clocked.admm_decode_launch.argtypes = lib.admm_decode_launch.argtypes
        clocked.admm_decode_launch.restype = ctypes.c_int
    report = {"card": card, "inputs": {}}
    names = sorted(INPUTS) if args.input == "all" else [args.input]
    seeds = [int(v) for v in args.seeds.split(",")]
    for name, seed in [(n, sd) for n in names for sd in seeds]:
        code_name, channel, param, cap, batch = INPUTS[name]
        code = get_code(code_name)
        g = code.graph
        t = bp_tables(g.to("cuda"))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        x = torch.ones((batch, code.get_n()), dtype=torch.int32,
                       device="cuda")
        mod = CHANNELS[channel]
        llr = mod.llr(mod.send(x, param, gen), param)
        kw = dict(mu=3.0, eps=1e-5, max_iter=cap, n_edge=g.n_edge)
        C, V, Dc = g.n_chk, g.n_var, g.max_chk_deg
        rule = admm_kernel.admm_geometry(C, V, Dc)
        ref = admm_kernel.admm_decode_cuda(llr, t, **kw)
        torch.cuda.synchronize()
        it = ref[1].float()
        line = (f"{name} seed {seed}: rule {tuple(rule)}; iterations mean "
                f"{float(it.mean()):.3f} median {float(it.median()):.1f} max "
                f"{int(it.max())}")
        batches = {"all": llr}
        if name == "margulis":
            head_it = it[:HEAD]
            line += (f"; first {HEAD} words: mean "
                     f"{float(head_it.mean()):.3f} max {int(head_it.max())}")
            batches["head"] = llr[:HEAD].contiguous()
        print(f"{line} | {card}", flush=True)
        rows = []
        for threads in [int(v) for v in args.threads.split(",")]:
            row = {"threads": threads}
            for which, inp in batches.items():
                ms = []
                for _ in range(3):
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = admm_kernel.admm_decode_cuda(inp, t,
                                                       threads=threads, **kw)
                    stop.record()
                    torch.cuda.synchronize()
                    ms.append(start.elapsed_time(stop))
                row[f"ms_{which}"] = min(ms)
                row[f"equal_{which}"] = all(
                    torch.equal(a, b[:inp.shape[0]])
                    for a, b in zip(out, ref))
            if clocked:
                admm_kernel._kernel_library = lambda: clocked
                try:
                    admm_kernel.admm_decode_cuda(llr, t, threads=threads,
                                                 **kw)
                finally:
                    admm_kernel._kernel_library = lambda: lib
                clk = (ctypes.c_ulonglong * 5)()
                clocked.admm_clocks(clk)
                total = float(sum(clk)) or 1.0
                row["clock_share"] = {p: clk[i] / total
                                      for i, p in enumerate(PHASES)}
            rows.append(row)
            print(f"  {name} seed {seed} {json.dumps(row)} | {card}",
                  flush=True)
        report["inputs"][f"{name} seed {seed}"] = {"rule": list(rule),
                                                   "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(report, fp, indent=1)


def _reg_count(line: str) -> int:
    return int(line.split("Used ")[1].split(" registers")[0])


if __name__ == "__main__":
    main()
