"""The SPA kernel on one CUDA device: time by launch geometry, ptxas and
SASS counts, and the split of an iteration.

    python scripts/profile_spa_kernel.py [--source FILE]
        [--input NAME,...|all|none]
        [--threads rule,128,256,...] [--seeds 3,...] [--plain] [--sass]
        [--clocks] [--straddle] [--out report.json]

``--source`` profiles another copy of ``csrc/spa_decode.cu`` (default: the
package's), for instance an earlier commit's; a source whose launch takes
no phi table (it exports no ``spa_phi_table_fill``) is called without one.
Each source is built here with the package's nvcc flags, and ptxas's
registers and spills are printed per instantiation.

Inputs (codeword 0, the timed inputs of ``chip_smoke.py`` where it has
them; seed 3 is that script's batch; ``none``: build and count only):

- ``flagship_ref`` / ``flagship_sat``: LDPC(1200,3,6), biAWGN 2.5 dB, bf16,
  reference / saturate policy, cap 10, B=16384;
- ``bsc``: LDPC(1200,3,6), BSC p=0.05, f32, reference, ``check_init``;
- ``caps_ref`` / ``caps_sat``: biAWGN 2.0 dB, bf16, caps (1,2,3,6,10,40,100);
- ``margulis``: margulis, biAWGN 2.25 dB, bf16, reference, cap 10;
- ``margulis_bsc``: margulis, BSC p=0.05, f32, reference (``campaign MAR``'s
  BSC SPA leg);
- ``ireg``: 1200_rho_x5_rand_ldpc_3, BSC p=0.05, f32, reference, cap 100
  (the cascade input);
- ``hamming``: Hamming(7,4), biAWGN 3.0 dB, bf16, reference, cap 10.

For each input: the mean iteration count, then per thread count (``rule``:
the one ``spa_geometry`` picks) the decode time by CUDA events, best of
three, and whether the outputs equal those of the first count timed; with
``--plain`` also whether they equal the plain version's.

``--sass`` counts, per kernel function of the built library
(``cuobjdump -sass``), the instructions, ``MUFU`` by kind, ``BRA``,
``BSSY``/``BSYNC``, ``CALL`` and predicated instructions.

``--clocks`` builds a copy with ``clock64()`` readings around the input phi
(or its table lookup), the output phi, the vote barrier, the variable pass,
the snapshot and the loop's end barrier, summed over thread 0 of every
CTA, and prints their shares of the loop at the first thread count given.

``--straddle`` builds a copy that counts, at each call of ``phi`` (the
output phi, and the input phi of f32 messages or of a source without the
table), the warps that call it and those whose lanes fall on both sides of
0.1, which run both of phi's forms, at the first thread count given.

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ldpc_decoders_tpu_torch.channels import CHANNELS  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.ops import _build, spa_kernel  # noqa: E402
from ldpc_decoders_tpu_torch.ops.graph import bp_tables  # noqa: E402

CAPS = (1, 2, 3, 6, 10, 40, 100)
FLAG = "1200_3_6_ldpc"
# name -> (code, channel, param, bf16, policy, caps or max_iter, check_init)
INPUTS = {
    "flagship_ref": (FLAG, "biawgn", 2.5, True, "reference", 10, False),
    "flagship_sat": (FLAG, "biawgn", 2.5, True, "saturate", 10, False),
    "bsc": (FLAG, "bsc", 0.05, False, "reference", 10, True),
    "caps_ref": (FLAG, "biawgn", 2.0, True, "reference", CAPS, False),
    "caps_sat": (FLAG, "biawgn", 2.0, True, "saturate", CAPS, False),
    "margulis": ("margulis", "biawgn", 2.25, True, "reference", 10, False),
    "margulis_bsc": ("margulis", "bsc", 0.05, False, "reference", 10, True),
    "ireg": ("1200_rho_x5_rand_ldpc_3", "bsc", 0.05, False, "reference",
             100, True),
    "hamming": ("7_4_hamming", "biawgn", 3.0, True, "reference", 10, False),
}
B = 16384
CLOCK_PHASES = ("input phi", "output phi", "check pass, the rest",
                "vote barrier", "variable pass", "snapshot", "end barrier")


def build(src: str, tag: str) -> tuple:
    """Compile ``src`` with the package's flags; returns (library, ptxas
    report lines)."""
    digest = hashlib.sha256(src.encode()).hexdigest()[:12]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, f"spa_profile_{tag}-{digest}.cu")
    so = cu[:-3] + ".so"
    with open(cu, "w") as fp:
        fp.write(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed on {tag}:\n{proc.stderr}")
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return ctypes.CDLL(so), so, report


class Kernel:
    """One build of the SPA kernel, launched through its C interface."""

    def __init__(self, lib: ctypes.CDLL):
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib = lib
        try:
            lib.spa_phi_table_fill
            self.has_table = True
        except AttributeError:
            self.has_table = False
        lib.spa_decode_launch.argtypes = (
            [p] * (6 if self.has_table else 5) + [i] * 9
            + [ctypes.POINTER(i), i, i, p])
        lib.spa_decode_launch.restype = i
        lib.spa_decode_error_string.argtypes = [i]
        lib.spa_decode_error_string.restype = ctypes.c_char_p
        self.table = None
        if self.has_table:
            lib.spa_phi_table_fill.argtypes = [p, p]
            lib.spa_phi_table_size.restype = i
            self.table = torch.empty(lib.spa_phi_table_size(),
                                     dtype=torch.float32, device="cuda")
            rc = lib.spa_phi_table_fill(
                self.table.data_ptr(), torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if rc:
                sys.exit("spa_phi_table_fill failed")

    def decode(self, llr, t, *, max_iter, check_init, bf16, ref, caps,
               threads):
        Dc, C = t.k_chk_var.shape
        Dv, V = t.k_var_slot.shape
        n = len(caps)
        x = torch.empty((n, llr.shape[0], V), dtype=torch.int32, device="cuda")
        it = torch.empty((llr.shape[0],), dtype=torch.int32, device="cuda")
        ptrs = [llr.data_ptr(), t.k_chk_var.data_ptr(),
                t.k_var_slot.data_ptr()]
        if self.has_table:
            ptrs.append(self.table.data_ptr() if bf16 else None)
        rc = self.lib.spa_decode_launch(
            *ptrs, x.data_ptr(), it.data_ptr(), llr.shape[0], C, V, Dc, Dv,
            max_iter, int(check_init), int(bf16), int(ref),
            (ctypes.c_int * n)(*caps), n, threads,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(self.lib.spa_decode_error_string(rc).decode())
        return x, it


def put(text: str, anchor: str, new: str, after: bool = True) -> str:
    at = text.index(anchor)
    if after:
        at += len(anchor)
    return text[:at] + new + text[at:]


PHI_DEF = "__device__ __forceinline__ float phi(float x) {"
LOOP_VARS = "  int kn = 0;  // next snapshot plane to write\n"
VOTE = "    if (!__syncthreads_or(unsat) && (it > 0 || check_init)) break;\n"
LOOP_END = "    __syncthreads();\n  }\n\n  // Planes the loop never reached"
KERNEL_END = "  if (threadIdx.x == 0) it_out[b] = it;\n"
OUT_PHI = "phi(fmaxf(excl, kPhiEps))"
TAB_CALL = re.compile(r"tab_at\(phi_tab, cl\)")


def clocked_source(src: str) -> str:
    """``src`` with the iteration split of ``--clocks`` (module docstring)."""
    src = put(src, "namespace {\n", "__device__ unsigned long long g_clk[7];\n")
    src = put(src, PHI_DEF, (
        "__device__ __forceinline__ float clk_start(float x, long long& t0) {\n"
        "  t0 = clock64();\n"
        "  float y;\n"
        "  asm volatile(\"mov.b32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n"
        "  return y;\n"
        "}\n"
        "__device__ __forceinline__ float clk_stop(float v, long long t0,\n"
        "                                          long long& acc) {\n"
        "  float w;\n"
        "  asm volatile(\"mov.b32 %0, %1;\" : \"=f\"(w) : \"f\"(v));\n"
        "  acc += clock64() - t0;\n"
        "  return w;\n"
        "}\n"), after=False)
    src = src.replace(OUT_PHI, "clk_stop(phi(clk_start(fmaxf(excl, kPhiEps), "
                               "t0)), t0, t_out)")
    src = src.replace("phi(cl)", "clk_stop(phi(clk_start(cl, t0)), t0, t_in)")
    src = TAB_CALL.sub("clk_stop(tab_at(phi_tab, clk_start(cl, t0)), t0, "
                       "t_in)", src)
    src = put(src, LOOP_VARS, "  long long t0 = 0, k0 = 0, k2 = 0, t_in = 0, "
                              "t_out = 0, t_chk = 0, t_vote = 0, t_var = 0, "
                              "t_snap = 0, t_end = 0;\n")
    src = put(src, "    // Check pass:", "    k0 = clock64();\n", after=False)
    src = src.replace(VOTE, (
        "    const long long k1 = clock64();\n"
        "    t_chk += k1 - k0;\n"
        "    const int vote = __syncthreads_or(unsat);\n"
        "    k2 = clock64();\n"
        "    t_vote += k2 - k1;\n"
        "    if (!vote && (it > 0 || check_init)) break;\n"))
    src = put(src, "    ++it;\n", "    const long long k3 = clock64();\n"
                                  "    t_var += k3 - k2;\n", after=False)
    src = src.replace(LOOP_END, (
        "    const long long k4 = clock64();\n"
        "    t_snap += k4 - k3;\n"
        "    __syncthreads();\n"
        "    t_end += clock64() - k4;\n"
        "  }\n\n  // Planes the loop never reached"))
    src = put(src, KERNEL_END, (
        "  if (threadIdx.x == 0) {\n"
        "    const long long part[7] = {t_in, t_out, t_chk - t_in - t_out,\n"
        "                               t_vote, t_var, t_snap, t_end};\n"
        "    for (int k = 0; k < 7; ++k) {\n"
        "      atomicAdd(&g_clk[k], (unsigned long long)part[k]);\n"
        "    }\n"
        "  }\n"), after=False)
    return src + (
        "\nextern \"C\" int spa_counters(unsigned long long* out, int n) {\n"
        "  cudaDeviceSynchronize();\n"
        "  cudaMemcpyFromSymbol(out, g_clk, n * sizeof(unsigned long long));\n"
        "  unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};\n"
        "  return (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));\n"
        "}\n")


def straddle_source(src: str) -> str:
    """``src`` with the mixed-warp counters of ``--straddle``."""
    src = put(src, "namespace {\n", "__device__ unsigned long long g_cnt[4];\n")
    phi_end = src.index("\n}\n", src.index(PHI_DEF)) + 3
    src = src[:phi_end] + ((
        "__device__ __forceinline__ float phi_site(float x, unsigned& calls,\n"
        "                                          unsigned& mixed) {\n"
        "  const unsigned m = __activemask();\n"
        "  const unsigned s = __ballot_sync(m, x < kPhiSmall);\n"
        "  if ((threadIdx.x & 31) == __ffs(m) - 1) {\n"
        "    ++calls;\n"
        "    mixed += (s != 0u && s != m) ? 1u : 0u;\n"
        "  }\n"
        "  return phi(x);\n"
        "}\n")) + src[phi_end:]
    src = src.replace(OUT_PHI, "phi_site(fmaxf(excl, kPhiEps), n_cnt[2], "
                               "n_cnt[3])")
    src = src.replace("phi(cl)", "phi_site(cl, n_cnt[0], n_cnt[1])")
    src = put(src, LOOP_VARS, "  unsigned n_cnt[4] = {0u, 0u, 0u, 0u};\n")
    src = put(src, KERNEL_END, (
        "  for (int k = 0; k < 4; ++k) {\n"
        "    if (n_cnt[k]) atomicAdd(&g_cnt[k], (unsigned long long)n_cnt[k]);\n"
        "  }\n"), after=False)
    return src + (
        "\nextern \"C\" int spa_counters(unsigned long long* out, int n) {\n"
        "  cudaDeviceSynchronize();\n"
        "  cudaMemcpyFromSymbol(out, g_cnt, n * sizeof(unsigned long long));\n"
        "  unsigned long long zero[4] = {0, 0, 0, 0};\n"
        "  return (int)cudaMemcpyToSymbol(g_cnt, zero, sizeof(zero));\n"
        "}\n")


def read_counters(lib: ctypes.CDLL, n: int) -> list:
    out = (ctypes.c_ulonglong * n)()
    lib.spa_counters(out, n)
    return list(out)


def sass_counts(so: str) -> dict:
    """Instruction counts per kernel function of a built library."""
    cuda_bin = os.path.dirname(_build._nvcc())
    dump = subprocess.run([os.path.join(cuda_bin, "cuobjdump"), "-sass", so],
                          capture_output=True, text=True).stdout
    filt = os.path.join(cuda_bin, "cu++filt")
    counts, name = {}, None
    ins = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)")
    for line in dump.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            if os.path.exists(filt):
                name = subprocess.run([filt, name], capture_output=True,
                                      text=True).stdout.strip() or name
            counts[name] = {"instructions": 0, "predicated": 0, "BRA": 0,
                            "BSSY": 0, "BSYNC": 0, "CALL": 0, "MUFU": {}}
            continue
        m = ins.search(line)
        if not (m and name):
            continue
        op = m.group(2)
        c = counts[name]
        c["instructions"] += 1
        c["predicated"] += bool(m.group(1))
        base = op.split(".")[0]
        if base in ("BRA", "BSSY", "BSYNC", "CALL"):
            c[base] += 1
        if base == "MUFU":
            c["MUFU"][op] = c["MUFU"].get(op, 0) + 1
    return counts


def make_input(name: str, seed: int):
    code_name, channel, param, bf16, policy, cap, check_init = INPUTS[name]
    code = get_code(code_name)
    t = bp_tables(code.graph.to("cuda"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.zeros((B, code.get_n()), dtype=torch.int32, device="cuda")
    mod = CHANNELS[channel]
    llr = mod.llr(mod.send(x, param, gen), param)
    caps = cap if isinstance(cap, tuple) else (cap,)
    kw = dict(max_iter=caps[-1], check_init=check_init, bf16=bf16,
              ref=policy == "reference", caps=caps)
    return code.graph, t, llr, kw, policy


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=os.path.join(_build.CSRC_DIR,
                                                     "spa_decode.cu"))
    ap.add_argument("--input", default="all")
    ap.add_argument("--threads", default="rule,128,192,256,320,384,448,512,"
                                         "640")
    ap.add_argument("--seeds", default="3")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--straddle", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    with open(args.source) as fp:
        src = fp.read()
    lib, so, ptxas = build(src, "plain")
    kern = Kernel(lib)
    print(f"source {args.source}: phi table {kern.has_table} | {card}")
    for line in ptxas:
        print(f"  ptxas {line}")
    report = {"card": card, "source": args.source, "ptxas": ptxas,
              "inputs": {}}
    if args.sass:
        report["sass"] = sass_counts(so)
        for fn, c in report["sass"].items():
            print(f"  sass {fn}: {json.dumps(c)}")
    extra = {}
    if args.clocks:
        extra["clocks"] = Kernel(build(clocked_source(src), "clocks")[0])
    if args.straddle:
        extra["straddle"] = Kernel(build(straddle_source(src),
                                         "straddle")[0])
    names = (list(INPUTS) if args.input == "all" else
             [] if args.input == "none" else args.input.split(","))
    for name in names:
        for seed in (int(v) for v in args.seeds.split(",")):
            g, t, llr, kw, policy = make_input(name, seed)
            rule = spa_kernel.spa_geometry(g.n_chk, g.n_var, g.max_chk_deg,
                                           kw["bf16"])
            counts = [rule.threads if v == "rule" else int(v)
                      for v in args.threads.split(",")]
            ref_out = None
            if args.plain:
                xp, ip = spa_kernel.spa_decode_plain(
                    llr, t, max_iter=kw["max_iter"],
                    check_init=kw["check_init"],
                    msg_dtype=torch.bfloat16 if kw["bf16"] else torch.float32,
                    inf_policy=policy,
                    caps=kw["caps"] if len(kw["caps"]) > 1 else None)
                ref_out = (xp.reshape(len(kw["caps"]), B, -1), ip)
            first = None
            rows = []
            key = f"{name} seed {seed}"
            for threads in counts:
                ms = []
                for _ in range(3):
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = kern.decode(llr, t, threads=threads, **kw)
                    stop.record()
                    torch.cuda.synchronize()
                    ms.append(start.elapsed_time(stop))
                first = first or out
                row = {"threads": threads, "ms": min(ms),
                       "mean_iters": float(out[1].float().mean()),
                       "equal_first": all(torch.equal(a, b) for a, b
                                          in zip(out, first))}
                if ref_out is not None:
                    row["equal_plain"] = all(torch.equal(a, b) for a, b
                                             in zip(out, ref_out))
                rows.append(row)
                print(f"  {key} {json.dumps(row)} | {card}", flush=True)
            entry = {"rule": list(rule), "rows": rows}
            for what, k in extra.items():
                n = 7 if what == "clocks" else 4
                read_counters(k.lib, n)                 # zero them
                out = k.decode(llr, t, threads=counts[0], **kw)
                torch.cuda.synchronize()
                vals = read_counters(k.lib, n)
                if not all(torch.equal(a, b) for a, b in zip(out, first)):
                    sys.exit(f"the {what} copy changed the outputs on {key}")
                if what == "clocks":
                    total = float(sum(vals)) or 1.0
                    entry["clocks"] = {p: vals[i] / total
                                       for i, p in enumerate(CLOCK_PHASES)}
                    entry["clocks_cycles"] = dict(zip(CLOCK_PHASES, vals))
                else:
                    entry["straddle"] = {
                        "input phi": {"warp_calls": vals[0],
                                      "mixed": vals[1]},
                        "output phi": {"warp_calls": vals[2],
                                       "mixed": vals[3]}}
                print(f"  {key} {what} at {counts[0]} threads: "
                      f"{json.dumps(entry[what])} | {card}", flush=True)
            report["inputs"][key] = entry
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(report, fp, indent=1)


if __name__ == "__main__":
    main()
