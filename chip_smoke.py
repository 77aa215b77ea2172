"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: a CUDA device must be present (there is no CPU fallback); the
   card's name and power limit as nvidia-smi reports them.
2. Build: both kernel sources (``ldpc_decoders_tpu_torch/csrc``:
   ``msa_decode.cu``, ``spa_decode.cu``) compile here, in parallel.
3. Kernels against their plain PyTorch versions on the card, B=4096.
   Tolerance: none — decisions and iteration counts must be bit-equal.
   - min-sum (``msa_decode_plain``), bf16 and f32: LDPC(1200,3,6) biAWGN
     at 1.5 and 3.0 dB, the irregular 1200_rho_x5_rand_ldpc_1 at 2.0 dB
     (``check_init=False``), and LDPC(1200,3,6) BSC p=0.05
     (``check_init=True``);
   - SPA (``spa_decode_plain``), both inf policies, bf16 and f32:
     LDPC(1200,3,6) biAWGN at 1.5 and 3.0 dB, LDPC(1200,3,6) BSC p=0.05,
     1200_rho_x5_rand_ldpc_3 BSC p=0.05 with 100 iterations, margulis
     biAWGN 2.25 dB.
4. The main paths through the CLI (``main.main``, codeword as stated,
   batch 16384). Each run's kernel launch count is set to 0 just before
   it and must have risen just after; each Saver file must have the JAX
   package's schema, and its WER must lie within |z| <= 4 (Agresti-Coull)
   of the committed artifact in ``artifacts/data``:
   - biAWGN LDPC(1200,3,6) MSA bf16 at 2.5 dB, codeword 1;
   - biAWGN LDPC(1200,3,6) SPA bf16 at 2.0 dB (reference policy);
   - BSC LDPC(1200,3,6) SPA f32 at p=0.06 (reference policy);
   - BSC 1200_rho_x5_rand_ldpc_3 SPA f32, 100 iterations, p=0.05, under
     the reference policy (the inf/NaN cascade) and under ``saturate``,
     whose WER must be at least 5x the reference policy's.
5. Timing at B=16384: the decode alone (CUDA events) and the whole step
   (sample -> LLR -> decode -> tally, host clock after a synchronize),
   through each kernel and through its plain version, in the order plain,
   kernel, kernel, plain: MSA bf16 biAWGN 3.0 dB; SPA reference and
   saturate bf16 biAWGN 2.5 dB; SPA reference f32 BSC p=0.05. Each kernel
   is also held bit-equal to its plain version at this shape.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACTS = os.path.join(ROOT, "artifacts", "data")
SAVER_KEYS = ["channel", "code", "decoder", "codeword", "min_wec", "max_iter",
              "tot", "wec", "wer", "bec", "ber", "words_per_sec"]
B_CHECK = 4096
B_STEP = 16384
FLAG = "1200_3_6_ldpc"
IREG = "1200_rho_x5_rand_ldpc_3"


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
        from ldpc_decoders_tpu_torch.channels import CHANNELS
        from ldpc_decoders_tpu_torch.codes import get_code
        from ldpc_decoders_tpu_torch.ops import _build, msa_kernel, spa_kernel
        from ldpc_decoders_tpu_torch.ops.graph import bp_tables
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    if not os.path.isdir(ARTIFACTS):
        fail(f"missing reference artifacts {ARTIFACTS}")

    # -- 1. device ---------------------------------------------------------
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"device: {name} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # -- 2. build both kernels at once ---------------------------------------
    t0 = time.time()
    sources = ("msa_decode", "spa_decode")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for fut in [pool.submit(_build.load_library, s) for s in sources]:
            try:
                fut.result()
            except RuntimeError as e:
                fail(f"kernel build failed: {e}")
    print(f"kernel build + load: {time.time() - t0:.1f} s", flush=True)
    for s in sources:
        log = _build.library_path(s) + ".log"
        if os.path.exists(log):
            with open(log) as fp:
                print(fp.read().strip(), flush=True)

    tables = {}

    def tab(code_name):
        if code_name not in tables:
            code = get_code(code_name)
            tables[code_name] = (code, bp_tables(code.graph.to("cuda")))
        return tables[code_name]

    def seeded_llr(code_name, channel, param, batch, seed, codeword=0):
        code, _ = tab(code_name)
        mod = CHANNELS[channel]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        x = torch.full((batch, code.get_n()), codeword, dtype=torch.int32,
                       device="cuda")
        return mod.llr(mod.send(x, param, gen), param)

    # -- 3. kernels == plain, bit for bit ------------------------------------
    # kernel name -> (its wrapper, its plain version)
    routes = {"msa_decode": (msa_kernel.msa_decode_cuda,
                             msa_kernel.msa_decode_plain),
              "spa_decode": (spa_kernel.spa_decode_cuda,
                             spa_kernel.spa_decode_plain),
              "spa_ref_decode": (spa_kernel.spa_decode_cuda,
                                 spa_kernel.spa_decode_plain)}
    max_err = dict.fromkeys(routes, 0)

    def check(kname, code_name, channel, param, kw):
        _, t = tab(code_name)
        cuda_fn, plain_fn = routes[kname]
        llr = seeded_llr(code_name, channel, param, B_CHECK,
                         seed=int(param * 1000) + len(code_name))
        xk, ik = cuda_fn(llr, t, **kw)
        xp, ip = plain_fn(llr, t, **kw)
        torch.cuda.synchronize()
        err = max(int((xk - xp).abs().max()), int((ik - ip).abs().max()))
        desc = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"check {kname} {code_name} {channel} {param} {desc}: "
              f"B={B_CHECK} max_abs_err={err} "
              f"words_differing={int((xk != xp).any(dim=1).sum())} "
              f"iters_differing={int((ik != ip).sum())} "
              f"mean_iters={float(ik.float().mean()):.3f} "
              f"wer={float(xk.any(dim=1).float().mean()):.5f}", flush=True)
        if err:
            fail(f"{kname} kernel != plain on {code_name} {channel} {param} "
                 f"({desc})")
        max_err[kname] = max(max_err[kname], err)

    msa_cases = [(FLAG, "biawgn", 1.5, False), (FLAG, "biawgn", 3.0, False),
                 ("1200_rho_x5_rand_ldpc_1", "biawgn", 2.0, False),
                 (FLAG, "bsc", 0.05, True)]
    for code_name, channel, param, check_init in msa_cases:
        for dt in msa_kernel.MSG_DTYPES:
            check("msa_decode", code_name, channel, param,
                  dict(max_iter=10, check_init=check_init, msg_dtype=dt))
    spa_cases = [(FLAG, "biawgn", 1.5, False, 10),
                 (FLAG, "biawgn", 3.0, False, 10),
                 (FLAG, "bsc", 0.05, True, 10),
                 (IREG, "bsc", 0.05, True, 100),
                 ("margulis", "biawgn", 2.25, False, 10)]
    for code_name, channel, param, check_init, max_iter in spa_cases:
        for policy in spa_kernel.INF_POLICIES:
            kname = "spa_ref_decode" if policy == "reference" else "spa_decode"
            for dt in msa_kernel.MSG_DTYPES:
                check(kname, code_name, channel, param,
                      dict(max_iter=max_iter, check_init=check_init,
                           msg_dtype=dt, inf_policy=policy))

    # -- 4. the main paths through the CLI ------------------------------------
    counters = {
        "msa_decode": (lambda: msa_kernel.msa_decode_cuda.launches,
                       lambda: setattr(msa_kernel.msa_decode_cuda,
                                       "launches", 0)),
        "spa_decode": (lambda: spa_kernel.spa_decode_cuda.launches["saturate"],
                       lambda: spa_kernel.spa_decode_cuda.launches.update(
                           saturate=0)),
        "spa_ref_decode": (
            lambda: spa_kernel.spa_decode_cuda.launches["reference"],
            lambda: spa_kernel.spa_decode_cuda.launches.update(reference=0)),
    }
    launches = dict.fromkeys(counters, 0)

    def cli_run(kname, argv, artifact, param):
        """One CLI run through kernel ``kname``; returns its WER."""
        read, reset = counters[kname]
        with tempfile.TemporaryDirectory() as tmp:
            reset()
            t0 = time.time()
            res = cli.main(argv + ["--batch", str(B_STEP), "--console",
                                   "--data_dir", tmp])
            n = read()
            secs = time.time() - t0
            files = glob.glob(os.path.join(tmp, "*.json"))
            if len(files) != 1:
                fail(f"CLI {' '.join(argv)} wrote {len(files)} Saver files")
            with open(files[0]) as fp:
                saved = json.load(fp)
        if n < 1:
            fail(f"the CLI run {' '.join(argv)} did not launch {kname}")
        launches[kname] += n
        if list(saved.keys()) != SAVER_KEYS:
            fail(f"Saver schema {list(saved.keys())} != {SAVER_KEYS}")
        with open(os.path.join(ARTIFACTS, artifact)) as fp:
            ref = json.load(fp)
        key = str(param)
        w_o, t_o = saved["wer"][key], saved["tot"][key]
        w_r, t_r = ref["wer"][key], ref["tot"][key]
        z = (w_o - w_r) / math.sqrt(ac_var(w_o, t_o) + ac_var(w_r, t_r))
        print(f"cli {' '.join(argv)}: {secs:.3f} s, {kname} launches={n}, "
              f"result={res[param]}", flush=True)
        print(f"cli WER at {key}: {w_o:.6f} ({saved['wec'][key]}/{t_o}) vs "
              f"artifact {artifact} {w_r:.6f} ({ref['wec'][key]}/{t_r}): "
              f"z={z:.3f}", flush=True)
        return w_o, z

    _, z = cli_run("msa_decode",
                   ["biawgn", FLAG, "MSA", "--params", "2.5", "--codeword",
                    "1", "--min-wec", "200", "--bf16"],
                   "biawgn-1200_3_6_ldpc-MSA-1-100-10.json", 2.5)
    if not abs(z) <= 4.0:
        fail(f"MSA CLI WER is |z|={abs(z):.2f} > 4 from the artifact")
    _, z = cli_run("spa_ref_decode",
                   ["biawgn", FLAG, "SPA", "--params", "2.0", "--codeword",
                    "0", "--min-wec", "200", "--bf16"],
                   "biawgn-1200_3_6_ldpc-SPA-0-100-10.json", 2.0)
    if not abs(z) <= 4.0:
        fail(f"biAWGN SPA CLI WER is |z|={abs(z):.2f} > 4 from the artifact")
    _, z = cli_run("spa_ref_decode",
                   ["bsc", FLAG, "SPA", "--params", "0.06", "--codeword",
                    "0", "--min-wec", "200"],
                   "bsc-1200_3_6_ldpc-SPA-0-100-10.json", 0.06)
    if not abs(z) <= 4.0:
        fail(f"BSC SPA CLI WER is |z|={abs(z):.2f} > 4 from the artifact")
    cascade = ["bsc", IREG, "SPA", "--max-iter", "100", "--params", "0.05",
               "--codeword", "0", "--min-wec", "100"]
    cascade_art = f"bsc-{IREG}-SPA-0-100-100.json"
    w_ref, z = cli_run("spa_ref_decode", cascade, cascade_art, 0.05)
    if not abs(z) <= 4.0:
        fail(f"refmode cascade CLI WER is |z|={abs(z):.2f} > 4 from the "
             "artifact")
    w_sat, _ = cli_run("spa_decode", cascade + ["--inf-policy", "saturate"],
                       cascade_art, 0.05)
    print(f"cascade: saturate WER {w_sat:.6f} = {w_sat / w_ref:.2f}x the "
          f"reference policy's {w_ref:.6f}", flush=True)
    if not w_sat >= 5.0 * w_ref:
        fail("the saturate policy's WER is not >= 5x the reference "
             "policy's on the cascade input")

    # -- 5. timing ------------------------------------------------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def time_case(kname, label, code_name, channel, param, kw, codeword):
        code, t = tab(code_name)
        mod = CHANNELS[channel]
        cuda_fn, plain_fn = routes[kname]
        route_fn = {"kernel": cuda_fn, "plain": plain_fn}

        def step(decode):
            x = torch.full((B_STEP, code.get_n()), codeword,
                           dtype=torch.int32, device="cuda")
            x_hat, _ = decode(mod.llr(mod.send(x, param, gen), param), t,
                              **kw)
            errs = (x_hat != x).sum(dim=-1)
            return torch.stack([(errs > 0).sum(), errs.sum()])

        def time_decode(decode, llr, reps):
            decode(llr, t, **kw)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                decode(llr, t, **kw)
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / reps

        def time_step(decode, reps):
            step(decode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tally = [step(decode) for _ in range(reps)]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            wec = sum(int(v[0]) for v in tally)
            return reps * B_STEP / dt, wec / (reps * B_STEP)

        llr = seeded_llr(code_name, channel, param, B_STEP, seed=3,
                         codeword=codeword)
        # The timed shape is the main path's: hold the kernel to its plain
        # version there too.
        xk, ik = cuda_fn(llr, t, **kw)
        xp, ip = plain_fn(llr, t, **kw)
        torch.cuda.synchronize()
        err = max(int((xk - xp).abs().max()), int((ik - ip).abs().max()))
        print(f"check {kname} {label}: B={B_STEP} max_abs_err={err}",
              flush=True)
        if err:
            fail(f"{kname} kernel != plain at B={B_STEP} ({label})")
        reps = {"kernel": 20, "plain": 3}
        ms = {"kernel": [], "plain": []}
        cws = {"kernel": [], "plain": []}
        for route in ("plain", "kernel", "kernel", "plain"):
            ms[route].append(time_decode(route_fn[route], llr, reps[route]))
            rate, wer = time_step(route_fn[route], reps[route])
            cws[route].append(rate)
            print(f"timing {label} {route}: decode {ms[route][-1]:.4f} ms at "
                  f"B={B_STEP}; whole step {rate:.1f} cw/s (wer {wer:.5f}) | "
                  f"{card}", flush=True)
        best = {r: min(v) for r, v in ms.items()}
        print(f"timing {label}: step cw/s kernel {max(cws['kernel']):.1f} vs "
              f"plain {max(cws['plain']):.1f}; decode ms kernel "
              f"{best['kernel']:.4f} vs plain {best['plain']:.4f} | {card}",
              flush=True)
        return best

    bf16, f32 = torch.bfloat16, torch.float32
    ms = {
        "msa_decode": time_case(
            "msa_decode", "msa bf16 biawgn 3.0 dB", FLAG, "biawgn", 3.0,
            dict(max_iter=10, check_init=False, msg_dtype=bf16), 1),
        "spa_ref_decode": time_case(
            "spa_ref_decode", "spa reference bf16 biawgn 2.5 dB", FLAG,
            "biawgn", 2.5, dict(max_iter=10, check_init=False,
                                msg_dtype=bf16, inf_policy="reference"), 0),
        "spa_decode": time_case(
            "spa_decode", "spa saturate bf16 biawgn 2.5 dB", FLAG, "biawgn",
            2.5, dict(max_iter=10, check_init=False, msg_dtype=bf16,
                      inf_policy="saturate"), 0),
    }
    time_case("spa_ref_decode", "spa reference f32 bsc 0.05", FLAG, "bsc",
              0.05, dict(max_iter=10, check_init=True, msg_dtype=f32,
                         inf_policy="reference"), 0)

    csrc = "ldpc_decoders_tpu_torch/csrc/"
    pallas = "ldpc_decoders_tpu/ops/pallas_bp.py:"
    sources = {"msa_decode": ("msa_decode.cu", "339"),
               "spa_decode": ("spa_decode.cu", "710"),
               "spa_ref_decode": ("spa_decode.cu", "838")}
    print(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": csrc + src,
        "replaces": pallas + line,
        "launches": launches[k],
        "max_abs_err": max_err[k],
        "ms": ms[k]["kernel"],
        "plain_ms": ms[k]["plain"],
    } for k, (src, line) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
