"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: a CUDA device must be present (there is no CPU fallback); the
   card's name and power limit as nvidia-smi reports them.
2. Kernel against its plain PyTorch version on the card: the CUDA min-sum
   kernel (built here from ``ldpc_decoders_tpu_torch/csrc``) and
   ``msa_decode_plain`` decode the same seeded LLRs at B=4096 on
   LDPC(1200,3,6) at 1.5 and 3.0 dB and on the irregular
   1200_rho_x5_rand_ldpc_1, in bf16 and in f32. Tolerance: none —
   decisions and iteration counts must be bit-equal.
3. The main path through the CLI: ``main.main`` runs biAWGN LDPC(1200,3,6)
   MSA bf16 at 2.5 dB, batch 16384, min_wec 200. The kernel's launch count
   must rise, the Saver file must have the JAX package's schema, and its
   WER must lie within |z| <= 4 (Agresti-Coull) of the committed artifact
   ``artifacts/data/biawgn-1200_3_6_ldpc-MSA-1-100-10.json``.
4. Timing at B=16384, 3.0 dB, bf16: the decode alone (CUDA events) and the
   whole step (sample -> LLR -> decode -> tally, host clock after a
   synchronize), through the kernel and through the plain version, in
   the order plain, kernel, kernel, plain.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(ROOT, "artifacts", "data",
                        "biawgn-1200_3_6_ldpc-MSA-1-100-10.json")
SAVER_KEYS = ["channel", "code", "decoder", "codeword", "min_wec", "max_iter",
              "tot", "wec", "wer", "bec", "ber", "words_per_sec"]
B_CHECK = 4096
B_STEP = 16384


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ac_var(w: float, t: int) -> float:
    """Agresti-Coull adjusted binomial variance of an observed rate."""
    p = (w * t + 2.0) / (t + 4.0)
    return p * (1.0 - p) / (t + 4.0)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def seeded_llr(torch, biawgn, n_var, batch, snr, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.zeros((batch, n_var), dtype=torch.int32, device="cuda")
    return biawgn.llr(biawgn.send(x, snr, gen), snr)


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA device and has no CPU fallback")
    sys.path.insert(0, ROOT)
    try:
        from ldpc_decoders_tpu_torch import main as cli
        from ldpc_decoders_tpu_torch.channels import biawgn
        from ldpc_decoders_tpu_torch.codes import get_code
        from ldpc_decoders_tpu_torch.ops import _build, msa_kernel
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    if not os.path.exists(ARTIFACT):
        fail(f"missing reference artifact {ARTIFACT}")

    # -- 1. device ---------------------------------------------------------
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # -- 2. kernel == plain, bit for bit ------------------------------------
    t0 = time.time()
    msa_kernel._kernel_library()
    log = _build.library_path("msa_decode") + ".log"
    print(f"kernel build + load: {time.time() - t0:.1f} s", flush=True)
    if os.path.exists(log):
        with open(log) as fp:
            print(fp.read().strip(), flush=True)
    max_err = 0
    cases = [("1200_3_6_ldpc", 1.5), ("1200_3_6_ldpc", 3.0),
             ("1200_rho_x5_rand_ldpc_1", 2.0)]
    for code_name, snr in cases:
        code = get_code(code_name)
        tables = msa_kernel.msa_tables(code.graph.to("cuda"))
        llr = seeded_llr(torch, biawgn, code.get_n(), B_CHECK, snr,
                         seed=int(snr * 100) + len(code_name))
        for dt in msa_kernel.MSG_DTYPES:
            kw = dict(max_iter=10, check_init=False, msg_dtype=dt)
            xk, ik = msa_kernel.msa_decode_cuda(llr, tables, **kw)
            xp, ip = msa_kernel.msa_decode_plain(llr, tables, **kw)
            torch.cuda.synchronize()
            err = max(int((xk - xp).abs().max()), int((ik - ip).abs().max()))
            words = int((xk != xp).any(dim=1).sum())
            wer = float(xk.any(dim=1).float().mean())
            print(f"check {code_name} {snr} dB {dt}: B={B_CHECK} "
                  f"max_abs_err={err} words_differing={words} "
                  f"iters_differing={int((ik != ip).sum())} "
                  f"mean_iters={float(ik.float().mean()):.3f} wer={wer:.5f}",
                  flush=True)
            if err:
                fail(f"kernel != plain on {code_name} at {snr} dB, {dt}")
            max_err = max(max_err, err)

    # -- 3. the main path through the CLI ----------------------------------
    msa_kernel.msa_decode_cuda.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        res = cli.main(["biawgn", "1200_3_6_ldpc", "MSA", "--params", "2.5",
                        "--codeword", "1", "--min-wec", "200",
                        "--batch", str(B_STEP), "--bf16", "--console",
                        "--data_dir", tmp])
        cli_s = time.time() - t0
        launches = msa_kernel.msa_decode_cuda.launches
        path = os.path.join(tmp, "biawgn-1200_3_6_ldpc-MSA-1-200-10.json")
        if not os.path.exists(path):
            fail(f"Saver file {os.path.basename(path)} was not written")
        with open(path) as fp:
            saved = json.load(fp)
    if launches < 1:
        fail("the CLI run did not launch the CUDA kernel")
    if list(saved.keys()) != SAVER_KEYS:
        fail(f"Saver schema {list(saved.keys())} != {SAVER_KEYS}")
    with open(ARTIFACT) as fp:
        ref = json.load(fp)
    w_o, t_o = saved["wer"]["2.5"], saved["tot"]["2.5"]
    w_r, t_r = ref["wer"]["2.5"], ref["tot"]["2.5"]
    z = (w_o - w_r) / math.sqrt(ac_var(w_o, t_o) + ac_var(w_r, t_r))
    print(f"cli: {cli_s:.1f} s, launches={launches}, result={res[2.5]}",
          flush=True)
    print(f"cli WER at 2.5 dB: {w_o:.5f} ({saved['wec']['2.5']}/{t_o}) vs "
          f"artifact {w_r:.5f} ({ref['wec']['2.5']}/{t_r}): z={z:.3f}",
          flush=True)
    if not abs(z) <= 4.0:
        fail(f"CLI WER is |z|={abs(z):.2f} > 4 from the artifact")

    # -- 4. timing -----------------------------------------------------------
    code = get_code("1200_3_6_ldpc")
    tables = msa_kernel.msa_tables(code.graph.to("cuda"))
    kw = dict(max_iter=10, check_init=False, msg_dtype=torch.bfloat16)
    routes = {"kernel": msa_kernel.msa_decode_cuda,
              "plain": msa_kernel.msa_decode_plain}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def step(decode):
        x = torch.ones((B_STEP, code.get_n()), dtype=torch.int32,
                       device="cuda")
        x_hat, _ = decode(biawgn.llr(biawgn.send(x, 3.0, gen), 3.0),
                          tables, **kw)
        errs = (x_hat != x).sum(dim=-1)
        return torch.stack([(errs > 0).sum(), errs.sum()])

    def time_decode(decode, llr, reps):
        decode(llr, tables, **kw)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            decode(llr, tables, **kw)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def time_step(decode, reps):
        step(decode)
        torch.cuda.synchronize()
        t = time.perf_counter()
        tally = [step(decode) for _ in range(reps)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        wec = sum(int(v[0]) for v in tally)
        return reps * B_STEP / dt, wec / (reps * B_STEP)

    llr = seeded_llr(torch, biawgn, code.get_n(), B_STEP, 3.0, seed=3)
    reps = {"kernel": 20, "plain": 3}
    ms = {"kernel": [], "plain": []}
    cws = {"kernel": [], "plain": []}
    for route in ("plain", "kernel", "kernel", "plain"):
        ms[route].append(time_decode(routes[route], llr, reps[route]))
        rate, wer = time_step(routes[route], reps[route])
        cws[route].append(rate)
        print(f"timing {route}: decode {ms[route][-1]:.4f} ms at B={B_STEP} "
              f"3.0 dB bf16; whole step {rate:.1f} cw/s (wer {wer:.5f}) | "
              f"{card}", flush=True)
    best = {r: min(v) for r, v in ms.items()}
    print(f"step cw/s kernel {max(cws['kernel']):.1f} vs plain "
          f"{max(cws['plain']):.1f}; decode ms kernel {best['kernel']:.4f} "
          f"vs plain {best['plain']:.4f} | {card}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "msa_decode",
        "route": "cuda",
        "source": "ldpc_decoders_tpu_torch/csrc/msa_decode.cu",
        "replaces": "ldpc_decoders_tpu/ops/pallas_bp.py:339",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": best["kernel"],
        "plain_ms": best["plain"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
