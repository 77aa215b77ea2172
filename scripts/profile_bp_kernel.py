"""The erasure and min-sum kernels on one CUDA device: time by launch
geometry, ptxas and SASS counts, and the split of an iteration.

    python scripts/profile_bp_kernel.py --kernel bec|msa [--source FILE]
        [--input NAME,...|all|none] [--geometry rule,1:8,...]
        [--seeds 3,...] [--plain] [--sass] [--clocks] [--no-snapshot]
        [--out report.json]

``--source`` profiles another copy of ``csrc/bec_decode.cu`` or
``csrc/msa_decode.cu`` (default: the package's), for instance an earlier
commit's. Each source is built here with the package's nvcc flags, and
ptxas's registers, spills and shared memory are printed per kernel
function.

Two launch interfaces are recognised by the symbols a build exports:

- one CTA per word (the kernels before the grouped form): a ``--geometry``
  entry is the threads per CTA (``rule``: 256, the count those wrappers
  launched);
- G warps per word and W words per CTA on a persistent grid (exports
  ``<kernel>_occupancy``): an entry is ``G:W``; ``rule`` is the geometry
  ``bec_geometry`` / ``msa_geometry`` picks.

Inputs (the timed inputs of ``chip_smoke.py`` phase 5, plus margulis and
Hamming(7,4); seed 3 is that script's batch; ``none``: build and count
only), B=16384:

- ``bec``: LDPC(1200,3,6), p=0.375, cap 10; ``bec_caps``: p=0.4, caps
  (1,2,3,6,10,40,100); ``bec_cap100``: p=0.4, cap 100 (the single-cap
  kernel beside ``bec_caps``); ``bec_margulis``: margulis p=0.375, cap 10;
  ``bec_hamming``: Hamming(7,4), p=0.3, cap 10;
- ``msa``: LDPC(1200,3,6), biAWGN 3.0 dB, bf16, cap 10, codeword 1;
  ``msa_caps``: 2.0 dB, bf16, the seven caps, codeword 1; ``msa_cap100``:
  2.0 dB, bf16, cap 100, codeword 1; ``msa_f32``: BSC p=0.05, f32,
  ``check_init``; ``msa_margulis``: margulis, biAWGN 2.25 dB, bf16;
  ``msa_hamming``: Hamming(7,4), biAWGN 3.0 dB, bf16.

For each input: the mean iteration count, then per geometry the decode
time by CUDA events, best of three, and whether the outputs equal those of
the first geometry timed; with ``--plain`` also the plain version's.

``--sass`` counts, per kernel function of the built library
(``cuobjdump -sass``), the instructions, ``BRA``, ``BAR``, ``LDG``,
``LDS``, ``STS`` and predicated instructions.

``--clocks`` builds a copy with ``clock64()`` readings around the check
pass, the barrier waits and votes, the variable pass and the snapshot,
summed over the first thread of every word, and prints their shares of
the loop at the first geometry given.

``--no-snapshot`` also times, on the single-cap inputs, a copy whose
per-iteration snapshot test is compiled out (its outputs must not change:
with one cap the loop never writes a plane): what the ``caps=`` support
costs a single-cap decode. A source whose single-cap instantiation has no
such test (``kPlanes``) is left as it is.

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
from ldpc_decoders_tpu_torch.ops import _build, bec_kernel, msa_kernel  # noqa: E402
from ldpc_decoders_tpu_torch.ops.graph import bp_tables  # noqa: E402

CAPS = (1, 2, 3, 6, 10, 40, 100)
FLAG = "1200_3_6_ldpc"
# name -> (code, channel, param, caps, codeword, bf16, check_init)
INPUTS = {
    "bec": (FLAG, "bec", 0.375, (10,), 0, None, None),
    "bec_caps": (FLAG, "bec", 0.4, CAPS, 0, None, None),
    "bec_cap100": (FLAG, "bec", 0.4, (100,), 0, None, None),
    "bec_margulis": ("margulis", "bec", 0.375, (10,), 0, None, None),
    "bec_hamming": ("7_4_hamming", "bec", 0.3, (10,), 0, None, None),
    "msa": (FLAG, "biawgn", 3.0, (10,), 1, True, False),
    "msa_caps": (FLAG, "biawgn", 2.0, CAPS, 1, True, False),
    "msa_cap100": (FLAG, "biawgn", 2.0, (100,), 1, True, False),
    "msa_f32": (FLAG, "bsc", 0.05, (10,), 0, False, True),
    "msa_margulis": ("margulis", "biawgn", 2.25, (10,), 0, True, False),
    "msa_hamming": ("7_4_hamming", "biawgn", 3.0, (10,), 0, True, False),
}
B = 16384
PHASES = ("check pass", "barriers and votes", "variable pass", "snapshot")
PARENT_THREADS = 256


def build(src: str, tag: str) -> tuple:
    """Compile ``src`` with the package's flags; returns (library, path,
    ptxas report lines)."""
    digest = hashlib.sha256(src.encode()).hexdigest()[:12]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, f"bp_profile_{tag}-{digest}.cu")
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
    """One build of the erasure or min-sum kernel, launched through its C
    interface (either of the two in the module docstring)."""

    def __init__(self, lib: ctypes.CDLL, kind: str):
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib, self.kind = lib, kind
        self.launch = getattr(lib, f"{kind}_decode_launch")
        self.grouped = hasattr(lib, f"{kind}_decode_occupancy")
        scalars = 6 if kind == "bec" else 8
        if self.grouped:
            self.launch.argtypes = ([p] * 6 + [i] * scalars
                                    + [ctypes.POINTER(i), i, i, i, p])
            self.occupancy = getattr(lib, f"{kind}_decode_occupancy")
            self.occupancy.argtypes = [i] * (7 if kind == "msa" else 6)
            self.occupancy.restype = i
        else:
            self.launch.argtypes = ([p] * 5 + [i] * scalars
                                    + [ctypes.POINTER(i), i, i, p])
        self.launch.restype = i
        err = getattr(lib, f"{kind}_decode_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        self.error = err

    def ctas_per_sm(self, t, geo, bf16) -> int:
        Dc, C = t.k_chk_var.shape
        Dv, V = t.k_var_slot.shape
        dims = [C, V, Dc, Dv] + ([int(bf16)] if self.kind == "msa" else [])
        return self.occupancy(*dims, *geo)

    def decode(self, inp, t, *, caps, geo, bf16=None, check_init=None):
        Dc, C = t.k_chk_var.shape
        Dv, V = t.k_var_slot.shape
        n = len(caps)
        x = torch.empty((n, inp.shape[0], V), dtype=torch.int32,
                        device="cuda")
        it = torch.empty((inp.shape[0],), dtype=torch.int32, device="cuda")
        head = [inp.data_ptr(), t.k_chk_var.data_ptr()]
        scalars = [inp.shape[0], C, V, Dc, Dv, caps[-1]]
        if self.kind == "msa":
            scalars += [int(check_init), int(bf16)]
        cap_arr = (ctypes.c_int * n)(*caps)
        stream = torch.cuda.current_stream().cuda_stream
        if self.grouped:
            nxt = torch.zeros((1,), dtype=torch.int32, device="cuda")
            rc = self.launch(*head, t.k_var_slot.data_ptr(), x.data_ptr(),
                             it.data_ptr(), nxt.data_ptr(), *scalars,
                             cap_arr, n, *geo, stream)
        else:
            rc = self.launch(*head, t.k_var_slot.data_ptr(), x.data_ptr(),
                             it.data_ptr(), *scalars, cap_arr, n, geo, stream)
        if rc:
            raise RuntimeError(self.error(rc).decode())
        return x, it


def put(text: str, anchor: str, new: str, after: bool = True) -> str:
    if anchor not in text:
        sys.exit(f"--clocks: anchor not found in the source: {anchor!r}")
    at = text.index(anchor)
    if after:
        at += len(anchor)
    return text[:at] + new + text[at:]


CLK = ("__device__ __forceinline__ long long clk() {\n"
       "  long long t;\n"
       "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t) :: \"memory\");\n"
       "  return t;\n"
       "}\n")
COUNTERS = ("\nextern \"C\" int bp_counters(unsigned long long* out, int n) {\n"
            "  cudaDeviceSynchronize();\n"
            "  cudaMemcpyFromSymbol(out, g_clk, n * sizeof(unsigned long long));\n"
            "  unsigned long long zero[4] = {0, 0, 0, 0};\n"
            "  return (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));\n"
            "}\n")
# Each kernel's loop, in both source forms: (anchor, text, where) with
# where "before", "after" or "replace". k0..k4 are the readings at the
# start of the check pass, its end, after the barrier that follows it, the
# end of the variable pass and the end of the snapshot; the barriers and
# votes after the snapshot close the iteration.
PARENT_CLOCKS = {
    "bec": [
        ("    // Check pass: v2c", "    k0 = clk();\n", "before"),
        ("    __syncthreads();  // c2v complete, marg no longer read\n",
         "    k1 = clk();\n    __syncthreads();\n    k2 = clk();\n"
         "    c_chk += k1 - k0;\n    c_bar += k2 - k1;\n", "replace"),
        ("    ++it;\n", "    k3 = clk();\n    c_var += k3 - k2;\n", "before"),
        ("    // Uniform votes;", "    k4 = clk();\n    c_snap += k4 - k3;\n",
         "before"),
        ("    done = stopped || !left;\n", "    c_bar += clk() - k4;\n",
         "after"),
    ],
    "msa": [
        ("    // Check pass: syndrome", "    k0 = clk();\n", "before"),
        ("    if (!__syncthreads_or(unsat) && (it > 0 || check_init)) break;\n",
         "    k1 = clk();\n    c_chk += k1 - k0;\n"
         "    const int vote_ = __syncthreads_or(unsat);\n    k2 = clk();\n"
         "    c_bar += k2 - k1;\n"
         "    if (!vote_ && (it > 0 || check_init)) break;\n", "replace"),
        ("    ++it;\n", "    k3 = clk();\n    c_var += k3 - k2;\n", "before"),
        ("    __syncthreads();\n  }\n\n  // Planes the loop never reached",
         "    k4 = clk();\n    c_snap += k4 - k3;\n    __syncthreads();\n"
         "    c_bar += clk() - k4;\n  }\n\n  // Planes the loop never reached",
         "replace"),
    ],
}
PARENT_START = "  int kn = 0;  // next snapshot plane to write\n"
PARENT_END = "  if (threadIdx.x == 0) it_out[b] = it;\n"
PARENT_LEAD = "threadIdx.x == 0"
GROUPED_CLOCKS = {
    "bec": [
        ("      // Check pass:", "      k0 = clk();\n", "before"),
        ("      grp.sync();  // rows complete, marg no longer read\n",
         "      k1 = clk();\n      grp.sync();\n      k2 = clk();\n"
         "      c_chk += k1 - k0;\n      c_bar += k2 - k1;\n", "replace"),
        ("      ++it;\n", "      k3 = clk();\n      c_var += k3 - k2;\n",
         "before"),
        ("      // Votes:", "      k4 = clk();\n      c_snap += k4 - k3;\n",
         "before"),
        ("      done = stopped || !left;\n", "      c_bar += clk() - k4;\n",
         "after"),
    ],
    "msa": [
        ("      // Check pass:", "      k0 = clk();\n", "before"),
        ("      const bool unsat_any = grp.any(unsat);\n",
         "      k1 = clk();\n      c_chk += k1 - k0;\n"
         "      const bool unsat_any = grp.any(unsat);\n      k2 = clk();\n"
         "      c_bar += k2 - k1;\n", "replace"),
        ("      ++it;\n", "      k3 = clk();\n      c_var += k3 - k2;\n",
         "before"),
        ("      grp.sync();  // marg complete\n",
         "      k4 = clk();\n      c_snap += k4 - k3;\n      grp.sync();\n"
         "      c_bar += clk() - k4;\n", "replace"),
    ],
}
GROUPED_START = "  const size_t plane = static_cast<size_t>(B) * V;\n"
GROUPED_END = "    if (grp.lane == 0) it_out[b] = it;\n  }\n"
GROUPED_LEAD = "grp.lane == 0"


def clocked_source(src: str, kind: str, grouped: bool) -> str:
    """``src`` with the iteration split of ``--clocks``."""
    src = put(src, "namespace {\n", "__device__ unsigned long long g_clk[4];\n"
              + CLK)
    edits = (GROUPED_CLOCKS if grouped else PARENT_CLOCKS)[kind]
    for anchor, text, where in edits:
        if where == "replace":
            src = put(src, anchor, "")
            src = src.replace(anchor, text, 1)
        else:
            src = put(src, anchor, text, after=where == "after")
    start, end, lead = ((GROUPED_START, GROUPED_END, GROUPED_LEAD) if grouped
                        else (PARENT_START, PARENT_END, PARENT_LEAD))
    src = put(src, start, "  long long k0 = 0, k1 = 0, k2 = 0, k3 = 0, k4 = 0;\n"
              "  long long c_chk = 0, c_bar = 0, c_var = 0, c_snap = 0;\n")
    src = put(src, end, (
        f"  if ({lead}) {{\n"
        "    const long long part[4] = {c_chk, c_bar, c_var, c_snap};\n"
        "    for (int k = 0; k < 4; ++k) {\n"
        "      atomicAdd(&g_clk[k], (unsigned long long)part[k]);\n"
        "    }\n"
        "  }\n"), after=grouped)
    return src + COUNTERS


SNAPSHOT_TEST = "if (it == caps.at[kn]) {"


def snapshot_free_source(src: str):
    """``src`` with the per-iteration snapshot test compiled out, or None
    where the single-cap kernel has no such test."""
    if "kPlanes && " + SNAPSHOT_TEST[4:] in src:
        return None
    if src.count(SNAPSHOT_TEST) != 1:
        sys.exit("--no-snapshot: the snapshot test is not in the source")
    return src.replace(SNAPSHOT_TEST, "if (false) {", 1)


def read_counters(lib: ctypes.CDLL) -> list:
    out = (ctypes.c_ulonglong * 4)()
    lib.bp_counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bp_counters(out, 4)
    return list(out)


def sass_counts(so: str) -> dict:
    """Instruction counts per kernel function of a built library."""
    cuda_bin = os.path.dirname(_build._nvcc())
    dump = subprocess.run([os.path.join(cuda_bin, "cuobjdump"), "-sass", so],
                          capture_output=True, text=True).stdout
    filt = os.path.join(cuda_bin, "cu++filt")
    counts, name = {}, None
    ins = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)")
    kinds = ("BRA", "BAR", "LDG", "LDS", "STS", "STG", "ATOMG", "RED")
    for line in dump.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            if os.path.exists(filt):
                name = subprocess.run([filt, name], capture_output=True,
                                      text=True).stdout.strip() or name
            counts[name] = dict.fromkeys(("instructions", "predicated")
                                         + kinds, 0)
            continue
        m = ins.search(line)
        if not (m and name):
            continue
        c = counts[name]
        c["instructions"] += 1
        c["predicated"] += bool(m.group(1))
        base = m.group(2).split(".")[0]
        if base in kinds:
            c[base] += 1
    return counts


def make_input(name: str, seed: int):
    code_name, channel, param, caps, codeword, bf16, check_init = INPUTS[name]
    code = get_code(code_name)
    t = bp_tables(code.graph.to("cuda"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.full((B, code.get_n()), codeword, dtype=torch.int32,
                   device="cuda")
    mod = CHANNELS[channel]
    y = mod.send(x, param, gen)
    inp = y if channel == "bec" else mod.llr(y, param)
    kw = dict(caps=caps)
    if bf16 is not None:
        kw.update(bf16=bf16, check_init=check_init)
    return code.graph, t, inp, kw


def rule_geometry(kind, g, bf16):
    if kind == "bec":
        geo = bec_kernel.bec_geometry(g.n_chk, g.n_var, g.max_chk_deg,
                                      g.max_var_deg)
    else:
        geo = msa_kernel.msa_geometry(g.n_chk, g.n_var, g.max_chk_deg,
                                      g.max_var_deg, bf16)
    return (geo.threads // 32, geo.words)


def plain_outputs(kind, inp, t, kw):
    caps = kw["caps"]
    more = dict(caps=caps) if len(caps) > 1 else {}
    if kind == "bec":
        x, it = bec_kernel.bec_spa_decode_plain(inp, t, max_iter=caps[-1],
                                                **more)
    else:
        x, it = msa_kernel.msa_decode_plain(
            inp, t, max_iter=caps[-1], check_init=kw["check_init"],
            msg_dtype=torch.bfloat16 if kw["bf16"] else torch.float32, **more)
    return x.reshape(len(caps), inp.shape[0], -1), it


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("bec", "msa"), required=True)
    ap.add_argument("--source", default=None)
    ap.add_argument("--input", default="all")
    ap.add_argument("--geometry", default="rule")
    ap.add_argument("--seeds", default="3")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--no-snapshot", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    kind = args.kernel
    source = args.source or os.path.join(_build.CSRC_DIR, f"{kind}_decode.cu")
    with open(source) as fp:
        src = fp.read()
    lib, so, ptxas = build(src, kind)
    kern = Kernel(lib, kind)
    print(f"source {source}: "
          f"{'G warps per word' if kern.grouped else 'one CTA per word'} "
          f"| {card}", flush=True)
    for line in ptxas:
        print(f"  ptxas {line}", flush=True)
    report = {"card": card, "source": source, "grouped": kern.grouped,
              "ptxas": ptxas, "inputs": {}}
    if args.sass:
        report["sass"] = sass_counts(so)
        for fn, c in report["sass"].items():
            print(f"  sass {fn}: {json.dumps(c)}", flush=True)
    clocked = None
    if args.clocks:
        clocked = Kernel(build(clocked_source(src, kind, kern.grouped),
                               kind + "_clocks")[0], kind)
    no_snap = None
    if args.no_snapshot:
        free = snapshot_free_source(src)
        if free is None:
            print("  --no-snapshot: the single-cap kernel has no snapshot "
                  "test", flush=True)
        else:
            no_snap = Kernel(build(free, kind + "_nosnap")[0], kind)
    names = ([n for n in INPUTS if n.split("_")[0] == kind]
             if args.input == "all" else
             [] if args.input == "none" else args.input.split(","))
    for name in names:
        for seed in (int(v) for v in args.seeds.split(",")):
            g, t, inp, kw = make_input(name, seed)
            geos = []
            for v in args.geometry.split(","):
                if not kern.grouped:
                    geos.append(PARENT_THREADS if v == "rule" else int(v))
                elif v == "rule":
                    geos.append(rule_geometry(kind, g, kw.get("bf16")))
                else:
                    geos.append(tuple(int(u) for u in v.split(":")))
            ref_out = plain_outputs(kind, inp, t, kw) if args.plain else None
            first, rows, key = None, [], f"{name} seed {seed}"
            for geo in geos:
                ms = []
                try:
                    for _ in range(3):
                        start = torch.cuda.Event(enable_timing=True)
                        stop = torch.cuda.Event(enable_timing=True)
                        start.record()
                        out = kern.decode(inp, t, geo=geo, **kw)
                        stop.record()
                        torch.cuda.synchronize()
                        ms.append(start.elapsed_time(stop))
                except RuntimeError as e:
                    print(f"  {key} geometry {geo}: refused ({e}) | {card}",
                          flush=True)
                    continue
                first = first or out
                row = {"geometry": geo, "ms": min(ms),
                       "mean_iters": float(out[1].float().mean()),
                       "equal_first": all(torch.equal(a, b) for a, b
                                          in zip(out, first))}
                if kern.grouped:
                    row["ctas_per_sm"] = kern.ctas_per_sm(t, geo,
                                                          kw.get("bf16"))
                if ref_out is not None:
                    row["equal_plain"] = all(torch.equal(a, b) for a, b
                                             in zip(out, ref_out))
                rows.append(row)
                print(f"  {key} {json.dumps(row)} | {card}", flush=True)
            entry = {"rows": rows}
            if no_snap is not None and first is not None \
                    and len(kw["caps"]) == 1:
                ms, out = [], None
                for _ in range(3):
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = no_snap.decode(inp, t, geo=geos[0], **kw)
                    stop.record()
                    torch.cuda.synchronize()
                    ms.append(start.elapsed_time(stop))
                if not all(torch.equal(a, b) for a, b in zip(out, first)):
                    sys.exit(f"the copy without snapshots changed {key}")
                entry["no_snapshot_ms"] = min(ms)
                print(f"  {key} without the snapshot test at {geos[0]}: "
                      f"{min(ms):.4f} ms | {card}", flush=True)
            if clocked is not None and first is not None:
                read_counters(clocked.lib)                  # zero them
                out = clocked.decode(inp, t, geo=geos[0], **kw)
                torch.cuda.synchronize()
                vals = read_counters(clocked.lib)
                if not all(torch.equal(a, b) for a, b in zip(out, first)):
                    sys.exit(f"the clocked copy changed the outputs on {key}")
                total = float(sum(vals)) or 1.0
                entry["clocks"] = {p: vals[i] / total
                                   for i, p in enumerate(PHASES)}
                entry["clocks_cycles"] = dict(zip(PHASES, vals))
                print(f"  {key} clocks at {geos[0]}: "
                      f"{json.dumps(entry['clocks'])} | {card}", flush=True)
            report["inputs"][key] = entry
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(report, fp, indent=1)


if __name__ == "__main__":
    main()
