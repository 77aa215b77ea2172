"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: a CUDA device must be present (there is no CPU fallback); the
   card's name and power limit as nvidia-smi reports them.
2. Build: the four kernel sources (``ldpc_decoders_tpu_torch/csrc``:
   ``msa_decode.cu``, ``spa_decode.cu``, ``bec_decode.cu``,
   ``admm_decode.cu``) compile here, in parallel.
3. Kernels against their plain PyTorch versions on the card, B=4096.
   Tolerance: none — decisions and iteration counts (and the ADMM
   kernel's fractional x) must be bit-equal.
   - min-sum (``msa_decode_plain``), bf16 and f32: LDPC(1200,3,6) biAWGN
     at 1.5 and 3.0 dB, the irregular 1200_rho_x5_rand_ldpc_1 at 2.0 dB,
     margulis at 2.25 dB and Hamming(7,4) at 3.0 dB (``check_init=False``),
     and LDPC(1200,3,6) BSC p=0.05 (``check_init=True``); each case (and
     each min-sum ``caps=`` case below) under the geometry the wrapper's
     rule picks and under every entry of ``MSA_GEOMETRIES``;
   - SPA (``spa_decode_plain``), both inf policies, bf16 and f32:
     LDPC(1200,3,6) biAWGN at 1.5 and 3.0 dB, LDPC(1200,3,6) BSC p=0.05,
     1200_rho_x5_rand_ldpc_3 BSC p=0.05 with 100 iterations, margulis
     biAWGN 2.25 dB; each case (and each SPA ``caps=`` case below) under
     the thread count the wrapper's rule picks and under every entry of
     ``SPA_THREADS``. Before them, the bf16 phi table the kernel library
     fills on the card must equal the plain ``phi`` on all its 7,561
     inputs;
   - erasure SPA (``bec_spa_decode_plain``): LDPC(1200,3,6) at p = 0.45,
     0.375 and 0.3 with caps 10 and 100 and in converge mode (bound
     2000), 1200_rho_x5_rand_ldpc_3 (padded slots) at p=0.4 cap 100,
     margulis at p=0.375, Hamming(7,4) at p=0.3; each case (and the
     erasure ``caps=`` case) also under every entry of
     ``BEC_GEOMETRIES``;
   - ``caps=`` snapshot planes, caps (1,2,3,6,10,40,100): each kernel
     against its plain ``caps=`` version AND each plane against the
     single-cap kernel at that cap: MSA bf16 biAWGN 2.0 dB and f32 BSC
     0.05; SPA under both policies bf16 biAWGN 2.0 dB and f32 BSC 0.07;
     erasure SPA p=0.4;
   - ADMM (``admm_decode_plain``), codeword 1, mu 3, eps 1e-5:
     LDPC(1200,3,6) at cap 50 on biAWGN 2.0 and 3.0 dB, BSC p=0.05 and BEC
     p=0.35 (+-1e8 LLRs); Hamming(7,4) (variable degrees 1..3) BSC p=0.1
     cap 50; 1200_rho_x5_rand_ldpc_3 (padded check slots) biAWGN 2.0 dB
     cap 50; margulis biAWGN 2.0 dB cap 100; margulis BSC p=0.07 in
     converge mode (bound 8000) on 128 words. Each case runs under the
     thread count the wrapper's rule picks and under every entry of
     ``ADMM_THREADS`` (threads per word): the outputs must not depend on
     the launch geometry.
   - every member of both ensembles (``campaign.ENSEMBLE_MEMBERS``: ten
     LDPC(1200,3,6) draws and ten 1200_rho_x5 irregular draws, six of
     them with variables of degree 0), B=1024, under each wrapper's rule:
     min-sum bf16 biAWGN 2.0 dB cap 10 and f32 BSC p=0.05, SPA under both
     policies bf16 biAWGN 2.0 dB cap 10 and f32 BSC p=0.05, erasure SPA
     p=0.4; the BSC and erasure cases at the ensemble's cap (10 on the
     regular members, 100 on the irregular ones);
   - the joint decoders (``EnsembleBPDecoder`` MSA bf16 and SPA reference
     bf16 at 2.0 dB, SPA saturate f32 BSC p=0.05, ``EnsembleBECSPADecoder``
     p=0.4) over the ten members of each ensemble at B=2048 per member:
     each member's decisions and iteration counts == its own
     ``BPDecoder`` / ``BECSPADecoder``'s.
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
     whose WER must be at least 5x the reference policy's;
   - BEC LDPC(1200,3,6) SPA at p=0.375 and 0.35, and with 100 iterations
     at p=0.4;
   - the iteration-cap sweep (``CapSweepRunner``, REG_BAD's labels
     0,1,2,3,6,10,40,100, one Saver file per label, each z-checked against
     its golden): BEC SPA at p=0.4 and 0.375, biAWGN MSA bf16 codeword 1
     at 2.0 dB, BSC SPA f32 at p=0.07; label 0 on biAWGN must give
     WER = BER = 1. A BSC SPA sweep under ``saturate`` drives that
     policy's ``caps=`` kernel (no golden: error counts must not rise
     with the cap). ``campaign REG_BAD --emit`` must print 40 lines;
   - ADMM, codeword 1: margulis in converge mode (``--max-iter 0
     --iter-cap 8000 --batch 2048``, the MAR goldens' configuration) at
     BSC p=0.07, BEC p=0.425 and biAWGN 1.75 dB; Hamming(7,4) ``--max-iter
     50`` at BSC p=0.1, BEC p=0.3 and biAWGN 3.0 dB; each Saver file must
     carry ``dec.average`` and a 2000-long ``dec.iter``. LDPC(1200,3,6)
     biAWGN 2.5 dB cap 50 has no golden: its WER must lie strictly
     between 0 and 1;
   - ML and LP (no kernel: a matrix product, and a host decoder) on
     Hamming(7,4) at the same three points against their goldens;
   - ``campaign HMG --emit`` and ``MAR --emit`` must print 14 and 8 lines;
     ``campaign HMG`` and ``campaign MAR`` (words per sweep point bounded
     by the goldens' own budget of 301056) run whole, and every sweep
     point of a Saver file that has a golden of the same name must be
     within |z| <= 4 of it, except LP on the BSC at p <= 0.006, where WER
     is a tie-break convention that differs by construction
     (``decoders/lp.py``);
   - the ensemble routes, as ``campaign REG_ENS`` / ``IREG_ENS`` configure
     their legs (``ENSEMBLE_LEGS``: REG_ENS biAWGN SPA bf16 at 2.0 dB and
     BEC SPA at p=0.4 and 0.35, cap 10; IREG_ENS BSC SPA f32 at p=0.05 and
     biAWGN MSA bf16 at 2.0 dB, cap 100): each leg through the rotating
     route (``run_rotating_members``) over the ten members, the first also
     through the joint route (``EnsembleMonteCarloRunner``); every member's
     Saver file has its golden's name and keys and lies within |z| <= 4 of
     it. The ensemble-mean file of the REG_ENS biAWGN SPA leg, rebuilt by
     ``viz.ens_average.dump_average`` from the member files, must equal the
     plain mean of the runs' results, and its WER lie within |z| <= 4 of
     the committed mean file. ``campaign REG_ENS --emit`` and ``IREG_ENS
     --emit`` must print 50 lines each. The two routes' throughput on the
     REG_ENS biAWGN SPA leg (all members' words per second over 131072
     words per member, set-up included; in the order rotating, joint,
     joint, rotating).
5. Timing at B=16384: the decode alone (CUDA events) and the whole step
   (sample -> LLR -> decode -> tally, host clock after a synchronize),
   through each kernel and through its plain version, in the order plain,
   kernel, kernel, plain: MSA bf16 biAWGN 3.0 dB; SPA reference and
   saturate bf16 biAWGN 2.5 dB; SPA reference f32 BSC p=0.05; erasure SPA
   p=0.375 cap 10. The ``caps=`` kernels (K=7, caps up to 100; decode
   only) beside the single-cap kernel at cap 100: MSA and SPA (both
   policies) bf16 biAWGN 2.0 dB, erasure SPA p=0.4. ADMM: LDPC(1200,3,6)
   biAWGN 2.5 dB cap 50; and margulis BSC p=0.07 in converge mode at
   B=2048, the kernel alone; the plain version is timed on the first 128
   words beside the kernel on the same 128 (``plain_ms`` with
   ``plain_batch`` and ``ms_at_plain_batch`` in the ``kernels`` line:
   measured, not scaled). Each kernel is also held bit-equal to its plain
   version at this shape. Both ADMM inputs are also timed under every
   entry of ``ADMM_THREADS`` (one line each), the two SPA bf16 2.5 dB
   inputs and margulis (biAWGN 2.25 dB, bf16, reference policy, the kernel
   alone) under every entry of ``SPA_THREADS``, and the min-sum and
   erasure inputs (single-cap and ``caps=``) under every entry of
   ``MSA_GEOMETRIES`` / ``BEC_GEOMETRIES``; the ADMM and SPA ``kernels``
   entries carry ``threads``, the count per word that the rule picked, and
   the min-sum and erasure entries ``geometry``, the rule's [warps per
   word, words per CTA]: ``ms`` was measured under them.

The ``kernels`` line gives each kernel's ``bound_ms``: the larger of the
bytes it must move (input read once, K output planes and the iteration
counts written once) over 3.35 TB/s, and its operations over 67 TFLOP/s
(the float32 rate outside the tensor cores; the erasure kernel's integer
operations are held to the same rate); for the SPA kernels also their
special-function operations over the card's special-function units (16
results per SM per clock, at the SM clock ``nvidia-smi`` reports as
``clocks.max.sm``). Operations are counted for this run's data: the sum
of the words' iteration counts times the edges of the graph times
``OPS_PER_EDGE_ITER`` arithmetic operations of the algorithm per edge and
iteration (a transcendental counts as one), and for SPA times
``SFU_OPS_PER_PHI`` special-function results per phi that is not a table
lookup: one per edge and iteration with bf16 messages, whose input phi is
a lookup, two with f32 messages. A phi needs one such result, whichever of
its two forms a lane takes (the kernel's SASS holds one ``MUFU.EX2`` for
the exp/log1p form and one ``MUFU.RCP`` for the series; ``logf`` and
``log1pf`` are polynomials on the FMA pipe). Where that term is the
largest, ``bound_by`` is ``operations`` and the printed line says ``sfu``.
ADMM's count depends on the data twice
over: ``admm_ops`` takes the updates the words needed and the check rows
whose projection needed the bracket search, as counted on the plain
version's run over the same input. No single PyTorch call computes a
whole BP or ADMM decode, so ``library_ms`` is null.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import glob
import io
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
CAPS = (1, 2, 3, 6, 10, 40, 100)
CAP_LABELS = [0, 1, 2, 3, 6, 10, 40, 100]
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Arithmetic operations of each algorithm per edge and iteration (check
# pass + variable pass; a transcendental counts as one operation).
OPS_PER_EDGE_ITER = {"msa_decode": 12, "spa_decode": 20,
                     "spa_ref_decode": 30, "bec_decode": 6}
# Special-function results per SM and clock (Hopper), and the least a phi
# that is not a table lookup needs of them: one ex2 (exp/log1p form) or one
# rcp (series form).
SFU_PER_SM_CLOCK = 16
SFU_OPS_PER_PHI = 1
ADMM_KW = dict(mu=3.0, eps=1e-5)
MAR_CAP = 8000          # the MAR goldens' bound on a run to convergence
B_MAR = 2048
B_MAR_PLAIN = 128
B_MEMBER = 1024         # every ensemble member, kernel against plain
B_JOINT = 2048          # words per member of the joint decoders and route
# The ensemble legs of phase 4: (case, channel, decoder, codeword, points);
# the points carry WER in the member goldens (p = 0.4 on the BEC at
# 0.94-0.96, the others 0.01-0.9).
ENSEMBLE_LEGS = (("REG_ENS", "biawgn", "SPA", 0, [2.0]),
                 ("REG_ENS", "bec", "SPA", 0, [0.4, 0.35]),
                 ("IREG_ENS", "bsc", "SPA", 0, [0.05]),
                 ("IREG_ENS", "biawgn", "MSA", 1, [2.0]))
ROUTE_WORDS = 131072    # words per member of each route's timed run
# Threads per word every ADMM case is also run under, beside the count the
# wrapper's rule picks.
ADMM_THREADS = (32, 128, 256, 320, 512, 704, 1024)
# Threads per word every SPA case is also run under.
SPA_THREADS = (32, 128, 192, 256, 320, 384, 448, 512, 640, 1024)
# (warps per word, words per CTA) every erasure / min-sum case is also run
# under: few and many words of one warp per CTA, one word of 2, 4 and 8
# warps per CTA; every graph of phase 3 takes each.
BEC_GEOMETRIES = ((1, 1), (1, 8), (1, 15), (2, 1), (4, 1), (8, 1))
MSA_GEOMETRIES = ((1, 1), (1, 5), (2, 1), (4, 1), (8, 1))


def launch_variants(kname: str) -> tuple:
    """(keyword, values): the launch geometries every case of kernel
    ``kname`` is also run under."""
    if kname.startswith("admm"):
        return "threads", ADMM_THREADS
    if kname.startswith("spa"):
        return "threads", SPA_THREADS
    if kname.startswith("bec"):
        return "geometry", BEC_GEOMETRIES
    return "geometry", MSA_GEOMETRIES


def admm_ops(word_iterations: int, bracket_rows: int, n_edge: int,
             n_var: int, dc: int) -> float:
    """Arithmetic operations of an ADMM decode, counted from the JAX
    package's ``_admm_core`` (a compare, select, clip bound or division
    counts as one).

    Per edge and update, whatever the row: x-update 3 (lam/mu, z - ., the
    sum) and 5 per variable (gamma/mu, -, /degree, clip); v = x_e + lam/mu
    2; rank 3 per other slot (>, ==, count); clip and its sum 3; f 1; f.z
    2; the choice of z_new 1; both norms 6; the dual update 2; per row 4
    (floor, mod, -, the f.z <= r test).
    Per row outside the polytope: 2*Dc candidates, each 3 to form, 5 per
    slot for T (the sign of beta*f, v -+ beta, clip, sum) and 6 to fold
    into the bracket; beta 6; z_new 3 per slot.
    At Dc = 6: 37.3 per edge and update, plus 492 per bracket row (82 per
    edge), so 119 where every row needs the search."""
    base = 20 + 3 * (dc - 1) + 5 * n_var / n_edge + 4 / dc
    bracket = 2 * dc * (9 + 5 * dc) + 6 + 3 * dc
    return word_iterations * n_edge * base + bracket_rows * bracket


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ac_var(w: float, t: int) -> float:
    """Agresti-Coull adjusted binomial variance of an observed rate."""
    p = (w * t + 2.0) / (t + 4.0)
    return p * (1.0 - p) / (t + 4.0)


def sm_clock_hz() -> float:
    """The card's largest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return 1e6 * float(out.stdout.strip().splitlines()[0])


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
        from ldpc_decoders_tpu_torch import campaign
        from ldpc_decoders_tpu_torch import main as cli
        from ldpc_decoders_tpu_torch.channels import CHANNELS
        from ldpc_decoders_tpu_torch.codes import get_code
        from ldpc_decoders_tpu_torch.decoders.bec_spa import BECSPADecoder
        from ldpc_decoders_tpu_torch.decoders.bp import BPDecoder
        from ldpc_decoders_tpu_torch.decoders.bp_ensemble import (
            EnsembleBECSPADecoder,
            EnsembleBPDecoder,
        )
        from ldpc_decoders_tpu_torch.harness import (
            CapSweepRunner,
            RunConfig,
            run_rotating_members,
        )
        from ldpc_decoders_tpu_torch.harness.ensemble_runner import (
            EnsembleMonteCarloRunner,
        )
        from ldpc_decoders_tpu_torch.ops import (
            _build,
            admm_kernel,
            bec_kernel,
            msa_kernel,
            spa_kernel,
        )
        from ldpc_decoders_tpu_torch.ops.graph import bp_tables
        from ldpc_decoders_tpu_torch.viz import ens_average
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    if not os.path.isdir(ARTIFACTS):
        fail(f"missing reference artifacts {ARTIFACTS}")

    # -- 1. device ---------------------------------------------------------
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    sfu_per_s = (SFU_PER_SM_CLOCK * sm_clock_hz()
                 * torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"device: {name} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # -- 2. build all kernels at once ----------------------------------------
    t0 = time.time()
    sources = ("msa_decode", "spa_decode", "bec_decode", "admm_decode")
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

    def soft(channel, y, param):
        """What the channel's BP decoder takes: the symbols on the BEC,
        the LLRs elsewhere."""
        return y if channel == "bec" else CHANNELS[channel].llr(y, param)

    def seeded_llr(code_name, channel, param, batch, seed, codeword=0,
                   llr_domain=False):
        """A BP decoder's input; with ``llr_domain`` the LLRs on the BEC
        too (ADMM: the +-1e8 / 0 table)."""
        code, _ = tab(code_name)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        x = torch.full((batch, code.get_n()), codeword, dtype=torch.int32,
                       device="cuda")
        y = CHANNELS[channel].send(x, param, gen)
        if llr_domain:
            return CHANNELS[channel].llr(y, param)
        return soft(channel, y, param)

    # -- 3. kernels == plain, bit for bit ------------------------------------
    # kernel name -> (its wrapper, its plain version)
    routes = {"msa_decode": (msa_kernel.msa_decode_cuda,
                             msa_kernel.msa_decode_plain),
              "spa_decode": (spa_kernel.spa_decode_cuda,
                             spa_kernel.spa_decode_plain),
              "spa_ref_decode": (spa_kernel.spa_decode_cuda,
                                 spa_kernel.spa_decode_plain),
              "bec_decode": (bec_kernel.bec_spa_decode_cuda,
                             bec_kernel.bec_spa_decode_plain)}
    # Every BP kernel has a single-cap entry and a ``caps=`` entry.
    knames = [k + sfx for k in routes for sfx in ("", "_caps")]
    # The one ADMM kernel stands for two TPU kernels: the dense-table one
    # (LDPC(1200,3,6), Hamming) and the factored-table one (margulis).
    for k in ("admm_decode", "admm_decode_margulis"):
        routes[k] = (admm_kernel.admm_decode_cuda,
                     admm_kernel.admm_decode_plain)
        knames.append(k)
    max_err = dict.fromkeys(knames, 0)

    def admm_kw(code_name, max_iter):
        return dict(ADMM_KW, max_iter=max_iter,
                    n_edge=tab(code_name)[0].graph.n_edge)

    def max_abs_diff(outs_a, outs_b):
        """Largest |a - b| over two tuples of tensors (0 = bit-equal up to
        the sign of zero)."""
        return max(float((a - b).abs().max()) for a, b in zip(outs_a, outs_b))

    def check(kname, code_name, channel, param, kw, batch=B_CHECK,
              codeword=0):
        _, t = tab(code_name)
        cuda_fn, plain_fn = routes[kname]
        llr = seeded_llr(code_name, channel, param, batch,
                         seed=int(param * 1000) + len(code_name),
                         codeword=codeword,
                         llr_domain=kname.startswith("admm"))
        out_k = cuda_fn(llr, t, **kw)
        out_p = plain_fn(llr, t, **kw)
        torch.cuda.synchronize()
        (xk, ik), (xp, ip) = out_k[:2], out_p[:2]
        err = max_abs_diff(out_k, out_p)
        desc = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"check {kname} {code_name} {channel} {param} {desc}: "
              f"B={batch} max_abs_err={err} "
              f"words_differing={int((xk != xp).any(dim=1).sum())} "
              f"iters_differing={int((ik != ip).sum())} "
              f"mean_iters={float(ik.float().mean()):.3f} "
              f"wer={float((xk != codeword).any(dim=1).float().mean()):.5f}",
              flush=True)
        if err:
            fail(f"{kname} kernel != plain on {code_name} {channel} {param} "
                 f"({desc})")
        max_err[kname] = max(max_err[kname], err)
        key, more = launch_variants(kname)
        for val in more:
            err = max_abs_diff(cuda_fn(llr, t, **{key: val}, **kw), out_p)
            if err:
                fail(f"{kname} kernel != plain on {code_name} {channel} "
                     f"{param} ({desc}) at {key} {val}: {err}")
        print(f"  and under {len(more)} more launch geometries: "
              "max_abs_err=0", flush=True)

    msa_cases = [(FLAG, "biawgn", 1.5, False), (FLAG, "biawgn", 3.0, False),
                 ("1200_rho_x5_rand_ldpc_1", "biawgn", 2.0, False),
                 ("margulis", "biawgn", 2.25, False),
                 ("7_4_hamming", "biawgn", 3.0, False),
                 (FLAG, "bsc", 0.05, True)]
    for code_name, channel, param, check_init in msa_cases:
        for dt in msa_kernel.MSG_DTYPES:
            check("msa_decode", code_name, channel, param,
                  dict(max_iter=10, check_init=check_init, msg_dtype=dt))

    def check_planes(kname, code_name, channel, param, kw):
        """caps= kernel == plain caps= version, and every plane == the
        single-cap kernel at that cap."""
        _, t = tab(code_name)
        cuda_fn, plain_fn = routes[kname]
        inp = seeded_llr(code_name, channel, param, B_CHECK,
                         seed=int(param * 1000) + 77)
        xs, its = cuda_fn(inp, t, max_iter=CAPS[-1], caps=CAPS, **kw)
        xp, ip = plain_fn(inp, t, max_iter=CAPS[-1], caps=CAPS, **kw)
        torch.cuda.synchronize()
        err = max(int((xs - xp).abs().max()), int((its - ip).abs().max()))
        key, more = launch_variants(kname)
        for val in more:
            xt, it_t = cuda_fn(inp, t, max_iter=CAPS[-1], caps=CAPS,
                               **{key: val}, **kw)
            err = max(err, int((xt - xp).abs().max()),
                      int((it_t - ip).abs().max()))
        for k, cap in enumerate(CAPS):
            x1, i1 = cuda_fn(inp, t, max_iter=cap, **kw)
            err = max(err, int((xs[k] - x1).abs().max()),
                      int((its.clamp(max=cap) - i1).abs().max()))
        desc = " ".join(f"{k}={v}" for k, v in kw.items())
        wers = [round(float(x.any(dim=1).float().mean()), 5) for x in xs]
        print(f"check {kname}_caps {code_name} {channel} {param} {desc}: "
              f"B={B_CHECK} K={len(CAPS)} max_abs_err={err} "
              f"mean_iters={float(its.float().mean()):.3f} wer_by_cap={wers}",
              flush=True)
        if err:
            fail(f"{kname} caps= kernel != plain or != the single-cap "
                 f"kernel on {code_name} {channel} {param} ({desc})")
        max_err[kname + "_caps"] = max(max_err[kname + "_caps"], err)

    # The bf16 phi table on the card against the plain phi, entry for entry.
    dev_tab = spa_kernel.phi_table_cuda("cuda")
    plain_tab = spa_kernel.phi_table_plain("cuda")
    torch.cuda.synchronize()
    tab_err = float((dev_tab - plain_tab).abs().max())
    tab_bits = int((dev_tab.view(torch.int32)
                    != plain_tab.view(torch.int32)).sum())
    print(f"check spa phi table: {dev_tab.numel()} entries, max_abs_err="
          f"{tab_err}, entries differing in their bits={tab_bits}",
          flush=True)
    if tab_err or tab_bits or not bool(torch.isfinite(dev_tab).all()):
        fail("the device phi table != the plain phi")

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
    for p_erase in (0.45, 0.375, 0.3):
        for max_iter in (10, 100, 2000):
            check("bec_decode", FLAG, "bec", p_erase, dict(max_iter=max_iter))
    check("bec_decode", IREG, "bec", 0.4, dict(max_iter=100))
    check("bec_decode", "margulis", "bec", 0.375, dict(max_iter=10))
    check("bec_decode", "7_4_hamming", "bec", 0.3, dict(max_iter=10))

    bf16, f32 = torch.bfloat16, torch.float32
    for channel, param, check_init, dt in (("biawgn", 2.0, False, bf16),
                                           ("bsc", 0.05, True, f32)):
        check_planes("msa_decode", FLAG, channel, param,
                     dict(check_init=check_init, msg_dtype=dt))
    for channel, param, check_init, dt in (("biawgn", 2.0, False, bf16),
                                           ("bsc", 0.07, True, f32)):
        for policy in spa_kernel.INF_POLICIES:
            kname = "spa_ref_decode" if policy == "reference" else "spa_decode"
            check_planes(kname, FLAG, channel, param,
                         dict(check_init=check_init, msg_dtype=dt,
                              inf_policy=policy))
    check_planes("bec_decode", FLAG, "bec", 0.4, {})

    for code_name, channel, param, max_iter, batch in (
            (FLAG, "biawgn", 2.0, 50, 2048), (FLAG, "biawgn", 3.0, 50, 2048),
            (FLAG, "bsc", 0.05, 50, 2048), (FLAG, "bec", 0.35, 50, 2048),
            ("7_4_hamming", "bsc", 0.1, 50, B_STEP),
            (IREG, "biawgn", 2.0, 50, 1024)):
        check("admm_decode", code_name, channel, param,
              admm_kw(code_name, max_iter), batch=batch, codeword=1)
    check("admm_decode_margulis", "margulis", "biawgn", 2.0,
          admm_kw("margulis", 100), batch=512, codeword=1)
    check("admm_decode_margulis", "margulis", "bsc", 0.07,
          admm_kw("margulis", MAR_CAP), batch=B_MAR_PLAIN, codeword=1)

    # Every member of both ensembles: kernel == plain at the wrapper's rule
    # (six of the IREG members hold variables of degree 0).
    def check_members(case):
        cap = campaign.ENSEMBLE_MAX_ITER.get(case, 10)
        cases = [("msa_decode", "biawgn", 2.0,
                  dict(max_iter=10, check_init=False, msg_dtype=bf16)),
                 ("msa_decode", "bsc", 0.05,
                  dict(max_iter=cap, check_init=True, msg_dtype=f32))]
        for policy in spa_kernel.INF_POLICIES:
            kname = "spa_ref_decode" if policy == "reference" else "spa_decode"
            cases += [(kname, "biawgn", 2.0,
                       dict(max_iter=10, check_init=False, msg_dtype=bf16,
                            inf_policy=policy)),
                      (kname, "bsc", 0.05,
                       dict(max_iter=cap, check_init=True, msg_dtype=f32,
                            inf_policy=policy))]
        cases.append(("bec_decode", "bec", 0.4, dict(max_iter=cap)))
        for i, member in enumerate(campaign.ENSEMBLE_MEMBERS[case]):
            code, t = tab(member)
            deg = code.graph.var_deg
            wers = []
            for kname, channel, param, kw in cases:
                cuda_fn, plain_fn = routes[kname]
                inp = seeded_llr(member, channel, param, B_MEMBER,
                                 seed=100 + i)
                out_k = cuda_fn(inp, t, **kw)
                out_p = plain_fn(inp, t, **kw)
                torch.cuda.synchronize()
                if max_abs_diff(out_k, out_p):
                    fail(f"{kname} kernel != plain on member {member} "
                         f"{channel} {param} ({kw})")
                wers.append(f"{float((out_k[0] != 0).any(dim=1).float().mean()):.4f}")
            print(f"check member {member}: {int((deg == 0).sum())} variables "
                  f"of degree 0, {int((deg == 1).sum())} of degree 1, "
                  f"{code.graph.n_edge} edges; {len(cases)} kernels == plain "
                  f"at B={B_MEMBER} (msa bf16 / f32, spa ref bf16 / f32, "
                  f"spa sat bf16 / f32, erasure; cap {cap}); "
                  f"wer {' '.join(wers)}", flush=True)

    def check_joint(case):
        """The joint decoders over the case's members on the card: each
        member's decisions and iteration counts == its own decoder's."""
        cap = campaign.ENSEMBLE_MAX_ITER.get(case, 10)
        graphs = [tab(m)[0].graph for m in campaign.ENSEMBLE_MEMBERS[case]]
        runs = (("msa bf16 biawgn 2.0 dB", "biawgn", 2.0,
                 dict(variant="MSA", msg_dtype=bf16, check_init=False)),
                ("spa reference bf16 biawgn 2.0 dB", "biawgn", 2.0,
                 dict(variant="SPA", msg_dtype=bf16, check_init=False)),
                ("spa saturate f32 bsc 0.05", "bsc", 0.05,
                 dict(variant="SPA", msg_dtype=f32, check_init=True,
                      inf_policy="saturate")),
                ("erasure bec 0.4", "bec", 0.4, None))
        for label, channel, param, kw in runs:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(11)
            x = torch.zeros((B_JOINT, graphs[0].n_var), dtype=torch.int32,
                            device="cuda")
            inp = torch.stack([soft(channel,
                                    CHANNELS[channel].send(x, param, gen),
                                    param) for _ in graphs])
            if kw is None:
                ens = EnsembleBECSPADecoder(graphs, max_iter=cap,
                                            device="cuda")
                own = [BECSPADecoder(g, max_iter=cap, device="cuda")
                       for g in graphs]
            else:
                ens = EnsembleBPDecoder(graphs, max_iter=cap, device="cuda",
                                        **kw)
                own = [BPDecoder(g, max_iter=cap, device="cuda", **kw)
                       for g in graphs]
            xs, its = ens.decode(inp)
            for g, dec in enumerate(own):
                if max_abs_diff((xs[g], its[g]), dec.decode(inp[g])):
                    fail(f"joint decoder {label} on {case}: member {g + 1} "
                         "!= its own decoder")
            print(f"check joint {case} {label}: {len(graphs)} members x "
                  f"B={B_JOINT}, cap {cap}: each == its own decoder; wer "
                  f"{float((xs != 0).any(dim=2).float().mean()):.4f}",
                  flush=True)

    for case in campaign.ENSEMBLE_MEMBERS:
        check_members(case)
        check_joint(case)

    # -- 4. the main paths through the CLI ------------------------------------
    def attr_counter(fn, attr):
        return (lambda: getattr(fn, attr), lambda: setattr(fn, attr, 0))

    def dict_counter(fn, attr, key):
        return (lambda: getattr(fn, attr)[key],
                lambda: getattr(fn, attr).update({key: 0}))

    # kernel name -> (read its launch count, set it to 0)
    msa_fn, spa_fn = msa_kernel.msa_decode_cuda, spa_kernel.spa_decode_cuda
    bec_fn = bec_kernel.bec_spa_decode_cuda
    counters = {
        "msa_decode": attr_counter(msa_fn, "launches"),
        "msa_decode_caps": attr_counter(msa_fn, "launches_caps"),
        "spa_decode": dict_counter(spa_fn, "launches", "saturate"),
        "spa_decode_caps": dict_counter(spa_fn, "launches_caps", "saturate"),
        "spa_ref_decode": dict_counter(spa_fn, "launches", "reference"),
        "spa_ref_decode_caps": dict_counter(spa_fn, "launches_caps",
                                            "reference"),
        "bec_decode": attr_counter(bec_fn, "launches"),
        "bec_decode_caps": attr_counter(bec_fn, "launches_caps"),
        # one kernel, one count: a run is booked on the entry it drives
        "admm_decode": attr_counter(admm_kernel.admm_decode_cuda, "launches"),
        "admm_decode_margulis": attr_counter(admm_kernel.admm_decode_cuda,
                                             "launches"),
    }
    launches = dict.fromkeys(counters, 0)

    def z_score(saved, ref, key):
        w_o, t_o = saved["wer"][key], saved["tot"][key]
        w_r, t_r = ref["wer"][key], ref["tot"][key]
        return (w_o - w_r) / math.sqrt(ac_var(w_o, t_o) + ac_var(w_r, t_r))

    def cli_run(kname, argv, artifact, param, batch=B_STEP, same_name=False):
        """One CLI run through kernel ``kname`` (None: a decoder without a
        kernel); its Saver file must have the artifact's keys, in order
        (and with ``same_name`` its file name). Returns its WER and the
        z-score against the artifact."""
        read, reset = counters[kname] if kname else (lambda: 0, lambda: None)
        with tempfile.TemporaryDirectory() as tmp:
            reset()
            t0 = time.time()
            res = cli.main(argv + ["--batch", str(batch), "--console",
                                   "--data_dir", tmp])
            n = read()
            secs = time.time() - t0
            files = glob.glob(os.path.join(tmp, "*.json"))
            if len(files) != 1:
                fail(f"CLI {' '.join(argv)} wrote {len(files)} Saver files")
            if same_name and os.path.basename(files[0]) != artifact:
                fail(f"CLI {' '.join(argv)} wrote {files[0]}, not {artifact}")
            with open(files[0]) as fp:
                saved = json.load(fp)
        if kname:
            if n < 1:
                fail(f"the CLI run {' '.join(argv)} did not launch {kname}")
            launches[kname] += n
        with open(os.path.join(ARTIFACTS, artifact)) as fp:
            ref = json.load(fp)
        if list(saved.keys()) != list(ref.keys()):
            fail(f"Saver schema {list(saved.keys())} != {list(ref.keys())}")
        key = str(param)
        w_o, t_o = saved["wer"][key], saved["tot"][key]
        w_r, t_r = ref["wer"][key], ref["tot"][key]
        z = z_score(saved, ref, key)
        shown = {k: v for k, v in res[param].items() if k != "dec"}
        print(f"cli {' '.join(argv)}: {secs:.3f} s, {kname} launches={n}, "
              f"result={shown}", flush=True)
        print(f"cli WER at {key}: {w_o:.6f} ({saved['wec'][key]}/{t_o}) vs "
              f"artifact {artifact} {w_r:.6f} ({ref['wec'][key]}/{t_r}): "
              f"z={z:.3f}", flush=True)
        if "dec" in ref:
            dec = saved["dec"][key]
            if list(dec) != ["average", "iter"] or len(dec["iter"]) != 2000 \
                    or sum(dec["iter"]) != t_o:
                fail(f"CLI {' '.join(argv)}: the iteration histogram is not "
                     "the 2000-bin count of every word")
            print(f"cli mean iterations at {key}: {dec['average']:.3f} vs "
                  f"artifact {ref['dec'][key]['average']:.3f}", flush=True)
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

    bec_art = "bec-1200_3_6_ldpc-SPA-0-100-%d.json"
    for argv, art, p_erase in (
            (["--params", "0.375"], bec_art % 10, 0.375),
            (["--params", "0.35"], bec_art % 10, 0.35),
            (["--params", "0.4", "--max-iter", "100"], bec_art % 100, 0.4)):
        _, z = cli_run("bec_decode",
                       ["bec", FLAG, "SPA", "--codeword", "0", "--min-wec",
                        "200"] + argv, art, p_erase)
        if not abs(z) <= 4.0:
            fail(f"BEC SPA CLI WER at {p_erase} is |z|={abs(z):.2f} > 4 "
                 "from the artifact")

    def cap_sweep(kname, golden, **cfg_kw):
        """One CapSweepRunner leg over REG_BAD's labels through the caps=
        kernel ``kname``; each label's Saver file is z-checked against its
        golden where ``golden`` is set. Returns {label: {param: stats}}."""
        read, reset = counters[kname]
        with tempfile.TemporaryDirectory() as tmp:
            cfg = RunConfig(min_wec=100, batch=B_STEP, data_dir=tmp,
                            device="cuda", log_freq=1e9, **cfg_kw)
            reset()
            t0 = time.time()
            res = CapSweepRunner(cfg, CAP_LABELS).run()
            n = read()
            secs = time.time() - t0
            if n < 1:
                fail(f"the cap sweep {cfg_kw} did not launch {kname}")
            launches[kname] += n
            stem = (f"{cfg.channel}-{cfg.code}-{cfg.decoder}-{cfg.codeword}-"
                    f"{cfg.min_wec}-")
            if sorted(os.listdir(tmp)) != sorted(
                    f"{stem}{lbl}.json" for lbl in CAP_LABELS):
                fail(f"cap sweep {cfg_kw} wrote {sorted(os.listdir(tmp))}")
            print(f"cap sweep {cfg_kw}: {secs:.3f} s, {kname} launches={n}",
                  flush=True)
            for lbl in CAP_LABELS:
                with open(os.path.join(tmp, f"{stem}{lbl}.json")) as fp:
                    saved = json.load(fp)
                if list(saved.keys()) != SAVER_KEYS or \
                        saved["max_iter"] != lbl:
                    fail(f"cap sweep Saver file of label {lbl}: "
                         f"{list(saved.keys())}, max_iter "
                         f"{saved['max_iter']}")
                for param in cfg.params:
                    key = str(param)
                    line = (f"  label {lbl} at {key}: WER "
                            f"{saved['wer'][key]:.6f} "
                            f"({saved['wec'][key]}/{saved['tot'][key]})")
                    if golden:
                        with open(os.path.join(ARTIFACTS,
                                               f"{stem}{lbl}.json")) as fp:
                            ref = json.load(fp)
                        z = z_score(saved, ref, key)
                        line += (f" vs golden {ref['wer'][key]:.6f} "
                                 f"({ref['wec'][key]}/{ref['tot'][key]}): "
                                 f"z={z:.3f}")
                        if not abs(z) <= 4.0:
                            fail(f"cap sweep {cfg_kw} label {lbl} at {key} "
                                 f"is |z|={abs(z):.2f} > 4 from its golden")
                    print(line, flush=True)
        for param in cfg.params:
            wecs = [res[lbl][param]["wec"] for lbl in CAP_LABELS]
            if wecs != sorted(wecs, reverse=True):
                fail(f"cap sweep {cfg_kw}: word errors rise with the cap "
                     f"at {param}: {wecs}")
        return res

    cap_sweep("bec_decode_caps", True, channel="bec", code=FLAG,
              decoder="SPA", params=[0.4, 0.375], codeword=0)
    res = cap_sweep("msa_decode_caps", True, channel="biawgn", code=FLAG,
                    decoder="MSA", params=[2.0], codeword=1,
                    msg_dtype="bfloat16")
    raw = res[0][2.0]
    if raw["wer"] != 1.0 or raw["ber"] != 1.0:
        fail(f"biAWGN cap label 0 must score WER = BER = 1, got {raw}")
    cap_sweep("spa_ref_decode_caps", True, channel="bsc", code=FLAG,
              decoder="SPA", params=[0.07], codeword=0)
    cap_sweep("spa_decode_caps", False, channel="bsc", code=FLAG,
              decoder="SPA", params=[0.07], codeword=0,
              inf_policy="saturate")
    emitted = io.StringIO()
    with contextlib.redirect_stdout(emitted):
        campaign.main(["REG_BAD", "--emit"])
    n_lines = len(emitted.getvalue().splitlines())
    print(f"campaign REG_BAD --emit: {n_lines} lines", flush=True)
    if n_lines != 40:
        fail(f"campaign REG_BAD --emit printed {n_lines} lines, not 40")

    # ADMM, ML and LP: the MAR goldens' configuration on margulis, and
    # Hamming(7,4) as the HMG goldens have it.
    mar_art = "%s-margulis-ADMM-1-100-3.0-1e-05-0-False.json"
    for channel, param in (("bsc", 0.07), ("bec", 0.425), ("biawgn", 1.75)):
        _, z = cli_run("admm_decode_margulis",
                       [channel, "margulis", "ADMM", "--codeword=1",
                        "--max-iter=0", "--iter-cap", str(MAR_CAP),
                        "--min-wec", "100", "--params", str(param)],
                       mar_art % channel, param, batch=B_MAR, same_name=True)
        if not abs(z) <= 4.0:
            fail(f"margulis ADMM CLI WER on {channel} at {param} is "
                 f"|z|={abs(z):.2f} > 4 from the artifact")
    hmg_art = {"ADMM": "%s-7_4_hamming-ADMM-1-300-3.0-1e-05-50-False.json",
               "ML": "%s-7_4_hamming-ML-1-300.json",
               "LP": "%s-7_4_hamming-LP-1-300-10-False.json"}
    for channel, param in (("bsc", 0.1), ("bec", 0.3), ("biawgn", 3.0)):
        for dec, extra in (("ADMM", ["--max-iter", "50"]), ("ML", []),
                           ("LP", [])):
            _, z = cli_run("admm_decode" if dec == "ADMM" else None,
                           [channel, "7_4_hamming", dec, "--codeword", "1",
                            "--min-wec", "300", "--params", str(param)]
                           + extra, hmg_art[dec] % channel, param,
                           same_name=True)
            if not abs(z) <= 4.0:
                fail(f"Hamming(7,4) {dec} CLI WER on {channel} at {param} "
                     f"is |z|={abs(z):.2f} > 4 from the artifact")
    # LDPC(1200,3,6) has no ADMM golden: the schema is margulis', the WER
    # must be a rate strictly inside (0, 1).
    read, reset = counters["admm_decode"]
    with tempfile.TemporaryDirectory() as tmp:
        reset()
        res = cli.main(["biawgn", FLAG, "ADMM", "--codeword", "1",
                        "--max-iter", "50", "--min-wec", "100", "--params",
                        "2.5", "--batch", str(B_STEP), "--console",
                        "--data_dir", tmp])
        n = read()
        with open(os.path.join(
                tmp, f"biawgn-{FLAG}-ADMM-1-100-3.0-1e-05-50-False.json")) as fp:
            saved = json.load(fp)
    with open(os.path.join(ARTIFACTS, mar_art % "biawgn")) as fp:
        if list(saved.keys()) != list(json.load(fp).keys()):
            fail(f"ADMM Saver schema {list(saved.keys())}")
    print(f"cli biawgn {FLAG} ADMM cap 50 at 2.5 dB: admm_decode launches="
          f"{n}, WER {res[2.5]['wer']:.6f} ({res[2.5]['wec']}/"
          f"{res[2.5]['tot']}), mean iterations "
          f"{res[2.5]['dec']['average']:.3f}", flush=True)
    if n < 1 or not 0.0 < res[2.5]["wer"] < 1.0:
        fail("the LDPC(1200,3,6) ADMM CLI run did not launch the kernel or "
             "gave no rate inside (0, 1)")
    launches["admm_decode"] += n

    for case, want in (("HMG", 14), ("MAR", 8)):
        emitted = io.StringIO()
        with contextlib.redirect_stdout(emitted):
            campaign.main([case, "--emit"])
        n_lines = len(emitted.getvalue().splitlines())
        print(f"campaign {case} --emit: {n_lines} lines", flush=True)
        if n_lines != want:
            fail(f"campaign {case} --emit printed {n_lines} lines, not {want}")

    def campaign_run(case, overrides):
        """Campaign ``case`` whole; every sweep point of a Saver file with
        a golden of the same name is z-checked against it."""
        read, reset = counters["admm_decode"]
        with tempfile.TemporaryDirectory() as tmp:
            reset()
            t0 = time.time()
            runs = campaign.run_campaign(
                [case], data_dir=tmp, overrides=dict(overrides, log_freq=1e9))
            torch.cuda.synchronize()
            secs = time.time() - t0
            n = read()
            names = sorted(os.listdir(tmp))
            print(f"campaign {case}: {len(runs)} runs, {len(names)} Saver "
                  f"files in {secs:.3f} s, admm_decode launches={n} | {card}",
                  flush=True)
            if n < 1 or len(names) != len(runs):
                fail(f"campaign {case}: {len(names)} files of {len(runs)} "
                     f"runs, {n} ADMM launches")
            for name in names:
                golden = os.path.join(ARTIFACTS, name)
                if not os.path.exists(golden):
                    print(f"  {name}: no golden", flush=True)
                    continue
                with open(os.path.join(tmp, name)) as fp:
                    saved = json.load(fp)
                with open(golden) as fp:
                    ref = json.load(fp)
                zs = {k: z_score(saved, ref, k) for k in saved["wer"]
                      if k in ref["wer"]}
                tie_tail = {k for k in zs if "-LP-" in name
                            and name.startswith("bsc-") and float(k) <= 0.006}
                worst = max(zs, key=lambda k: abs(zs[k]))
                print(f"  {name}: {len(zs)} points, max |z| "
                      f"{abs(zs[worst]):.3f} at {worst}"
                      + (f" (tie-break tail {sorted(tie_tail)} not held)"
                         if tie_tail else ""), flush=True)
                over = {k: round(zs[k], 3) for k in zs
                        if abs(zs[k]) > 4.0 and k not in tie_tail}
                if over:
                    fail(f"campaign {case}: {name} is |z| > 4 from its "
                         f"golden at {over}")

    campaign_run("HMG", {})
    campaign_run("MAR", {"max_words": 301056})

    def leg_config(case, channel, decoder, codeword, params, joint, **kw):
        """The RunConfig ``campaign.run_campaign`` gives this ensemble leg
        (bf16 messages on biAWGN, f32 on the BSC, batch 2048 per member on
        the joint route), at ``params``."""
        return RunConfig(
            channel, case, decoder, params, codeword=codeword,
            max_iter=campaign.ENSEMBLE_MAX_ITER.get(case, 10),
            msg_dtype="bfloat16" if channel == "biawgn" else "float32",
            batch=B_JOINT if joint else 4096, device="cuda", log_freq=1e9,
            **kw)

    def run_route(cfg, joint):
        members = campaign.ENSEMBLE_MEMBERS[cfg.code]
        if joint:
            return EnsembleMonteCarloRunner(cfg, members).run()
        return run_rotating_members(cfg, members)

    def ensemble_leg(case, channel, decoder, codeword, params, joint=False):
        """One leg of ``case`` over its ten members through the rotating
        (or joint) route; every member's Saver file must have the golden's
        name and keys and lie within |z| <= 4 of it at each point. On the
        REG_ENS biAWGN SPA leg the ensemble-mean file is rebuilt from the
        member files and checked (``check_average``)."""
        kname = ("bec_decode" if channel == "bec" else
                 "msa_decode" if decoder == "MSA" else "spa_ref_decode")
        read, reset = counters[kname]
        members = campaign.ENSEMBLE_MEMBERS[case]
        route = "joint" if joint else "rotating"
        with tempfile.TemporaryDirectory() as tmp:
            cfg = leg_config(case, channel, decoder, codeword, params, joint,
                             data_dir=tmp)
            reset()
            t0 = time.time()
            res = run_route(cfg, joint)
            torch.cuda.synchronize()
            secs = time.time() - t0
            n = read()
            if n < len(members):
                fail(f"{route} {case} {channel} {decoder}: {n} {kname} "
                     f"launches for {len(members)} members")
            launches[kname] += n
            stem = f"{channel}-%s-{decoder}-{codeword}-100-{cfg.max_iter}.json"
            if sorted(os.listdir(tmp)) != sorted(stem % m for m in members):
                fail(f"{route} {case}: Saver files {sorted(os.listdir(tmp))}")
            worst = 0.0
            for m in members:
                with open(os.path.join(tmp, stem % m)) as fp:
                    saved = json.load(fp)
                with open(os.path.join(ARTIFACTS, stem % m)) as fp:
                    ref = json.load(fp)
                if list(saved) != SAVER_KEYS or list(ref) != SAVER_KEYS:
                    fail(f"{route} {case} {m}: Saver keys {list(saved)}")
                for p in params:
                    z = z_score(saved, ref, str(p))
                    worst = max(worst, abs(z))
                    print(f"  {route} {m} {channel} {decoder} at {p}: WER "
                          f"{saved['wer'][str(p)]:.6f} ({saved['wec'][str(p)]}"
                          f"/{saved['tot'][str(p)]}) vs golden "
                          f"{ref['wer'][str(p)]:.6f} ({ref['wec'][str(p)]}/"
                          f"{ref['tot'][str(p)]}): z={z:.3f}", flush=True)
                    if not abs(z) <= 4.0:
                        fail(f"{route} {case} {m} {channel} {decoder} at {p} "
                             f"is |z|={abs(z):.2f} > 4 from its golden")
            print(f"ensemble {route} {case} {channel} {decoder} cap "
                  f"{cfg.max_iter} at {params}: {len(members)} members in "
                  f"{secs:.3f} s, {kname} launches={n}, max |z| "
                  f"{worst:.3f} | {card}", flush=True)
            if channel == "biawgn" and decoder == "SPA" and not joint:
                check_average(tmp, channel, decoder, res, params)

    def check_average(data_dir, channel, decoder, res, params):
        """The ensemble-mean file rebuilt by the port's ``ens_average``
        from the member files == the plain mean of the runs' results (the
        reference's rule: members string-sorted, each point the mean over
        the members that hold it), and its WER within |z| <= 4 of the
        committed mean file of the JAX package's member goldens."""
        prefix = "1200_3_6_rand_ldpc"
        with tempfile.TemporaryDirectory() as out:
            path = ens_average.dump_average(data_dir, channel, prefix,
                                            decoder, out_dir=out)
            with open(path) as fp:
                got = json.load(fp)
        sources = sorted(res)
        want = {"channel": channel, "prefix": prefix, "decoder": decoder,
                "sources": sources,
                "wer": {str(p): sum(res[m][p]["wer"] for m in sources)
                        / len(sources) for p in params},
                "ber": {str(p): sum(res[m][p]["ber"] for m in sources)
                        / len(sources) for p in params}}
        if os.path.basename(path) != f"{channel}-{prefix}-{decoder}.json" \
                or got != want:
            fail(f"ens_average {os.path.basename(path)} != the members' mean")
        with open(os.path.join(
                ARTIFACTS, f"{channel}-{prefix}-{decoder}.json")) as fp:
            ref = json.load(fp)
        for p in params:
            key = str(p)
            var = 0.0
            for m in sources:
                with open(os.path.join(
                        ARTIFACTS, f"{channel}-{m}-{decoder}-0-100-10.json")) \
                        as fp:
                    gold = json.load(fp)
                var += (ac_var(res[m][p]["wer"], res[m][p]["tot"])
                        + ac_var(gold["wer"][key], gold["tot"][key]))
            z = (got["wer"][key] - ref["wer"][key]) / math.sqrt(
                var / len(sources) ** 2)
            print(f"ens_average {channel}-{prefix}-{decoder}.json at {key}: "
                  f"== the members' mean; WER {got['wer'][key]:.6f} vs the "
                  f"committed mean {ref['wer'][key]:.6f}: z={z:.3f}",
                  flush=True)
            if not abs(z) <= 4.0:
                fail(f"ensemble mean at {key} is |z|={abs(z):.2f} > 4 from "
                     "the committed mean")

    for case in campaign.ENSEMBLE_MEMBERS:
        emitted = io.StringIO()
        with contextlib.redirect_stdout(emitted):
            campaign.main([case, "--emit"])
        n_lines = len(emitted.getvalue().splitlines())
        print(f"campaign {case} --emit: {n_lines} lines", flush=True)
        if n_lines != 50:
            fail(f"campaign {case} --emit printed {n_lines} lines, not 50")
    for leg in ENSEMBLE_LEGS:
        ensemble_leg(*leg)
    ensemble_leg(*ENSEMBLE_LEGS[0], joint=True)

    def route_rate(joint):
        """Words of all members per second through one route over
        ``ROUTE_WORDS`` words per member of the REG_ENS biAWGN SPA 2.0 dB
        leg, host clock around the whole call (set-up included)."""
        cfg = leg_config("REG_ENS", "biawgn", "SPA", 0, [2.0], joint,
                         min_wec=10 ** 12, max_words=ROUTE_WORDS)
        t0 = time.perf_counter()
        res = run_route(cfg, joint)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        words = sum(leg[2.0]["tot"] for leg in res.values())
        return words / secs, words

    rates = {"rotating": [], "joint": []}
    for route in ("rotating", "joint", "joint", "rotating"):
        rate, words = route_rate(route == "joint")
        rates[route].append(rate)
        print(f"timing ensemble route {route} REG_ENS biawgn SPA bf16 2.0 dB: "
              f"{words} words in {words / rate:.3f} s, {rate:.1f} cw/s | "
              f"{card}", flush=True)
    print(f"timing ensemble routes: rotating {max(rates['rotating']):.1f} vs "
          f"joint {max(rates['joint']):.1f} cw/s (batch 4096 per chunk vs "
          f"{B_JOINT} per member and chunk) | {card}", flush=True)

    # -- 5. timing ------------------------------------------------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    @contextlib.contextmanager
    def bracket_counts():
        """While open, each projection the plain ADMM version makes also
        records, per word, how many check rows needed the bracket search:
        the rows whose projection is not their cube-clip. Yields the list
        of [B] counts, one per iteration."""
        real = admm_kernel.project_parity_polytope
        counts = []

        def counting(v, mask):
            out = real(v, mask=mask)
            clip = torch.where(mask, v.clamp(0.0, 1.0), 0.0)
            counts.append((out != clip).any(dim=-1).sum(dim=-1))
            return out

        admm_kernel.project_parity_polytope = counting
        try:
            yield counts
        finally:
            admm_kernel.project_parity_polytope = real

    def admm_work(counts, iters, cap):
        """(updates applied, bracket rows of the words still running),
        summed over the batch: a word with ``iters`` below the cap made
        ``iters + 1`` updates, and the plain version goes on projecting a
        frozen word's rows, which do not count."""
        updates = iters + (iters < cap)
        per_iter = torch.stack(counts)                           # [I, B]
        step_no = torch.arange(len(counts), device=iters.device)
        running = step_no[:, None] < updates[None, :]
        return int(updates.sum()), int((per_iter * running).sum())

    def rule_launch(kname, code_name, msg_dtype=None):
        """The launch geometry the wrapper picks on this graph: threads per
        word (ADMM, SPA with ``msg_dtype``), or [warps per word, words per
        CTA] (erasure, min-sum with ``msg_dtype``)."""
        g = tab(code_name)[0].graph
        dims = (g.n_chk, g.n_var, g.max_chk_deg)
        if kname.startswith("admm"):
            return admm_kernel.admm_geometry(*dims).threads
        if kname.startswith("spa"):
            return spa_kernel.spa_geometry(*dims, msg_dtype == bf16).threads
        if kname.startswith("bec"):
            geo = bec_kernel.bec_geometry(*dims, g.max_var_deg)
        else:
            geo = msa_kernel.msa_geometry(*dims, g.max_var_deg,
                                          msg_dtype == bf16)
        return [geo.threads // 32, geo.words]

    def time_geometries(kname, label, code_name, llr, kw, want):
        """One line per entry of ``launch_variants(kname)``: the decode's
        time under it (CUDA events, the better of two), its outputs held
        equal to ``want``."""
        _, t = tab(code_name)
        cuda_fn = routes[kname][0]
        key, more = launch_variants(kname)
        for val in more:
            ms = []
            for _ in range(2):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out = cuda_fn(llr, t, **{key: val}, **kw)
                stop.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(stop))
            if max_abs_diff(out, want):
                fail(f"{kname} at {key} {val} != at the rule's ({label})")
            print(f"timing {label} at {key} {val}: decode {min(ms):.4f} ms "
                  f"at B={llr.shape[0]} | {card}", flush=True)

    def time_case(kname, label, code_name, channel, param, kw, codeword,
                  caps=None):
        """Times kernel ``kname`` and its plain version at B=16384 and
        works out the kernel's bound from this input. With ``caps`` the
        ``caps=`` form is timed (decode only), beside the single-cap
        kernel at ``caps[-1]``. Returns the kernel's ``kernels``-line
        numbers."""
        code, t = tab(code_name)
        mod = CHANNELS[channel]
        cuda_fn, plain_fn = routes[kname]
        if caps:
            kw = dict(kw, max_iter=caps[-1])
            single_kw, kw = kw, dict(kw, caps=caps)
        route_fn = {"kernel": cuda_fn, "plain": plain_fn}

        def step(decode):
            x = torch.full((B_STEP, code.get_n()), codeword,
                           dtype=torch.int32, device="cuda")
            x_hat = decode(soft(channel, mod.send(x, param, gen), param),
                           t, **kw)[0]
            errs = (x_hat != x).sum(dim=-1)
            return torch.stack([(errs > 0).sum(), errs.sum()])

        def time_decode(decode, llr, reps, kw=kw):
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
        is_admm = kname.startswith("admm")
        out_k = cuda_fn(llr, t, **kw)
        with bracket_counts() as counts:
            out_p = plain_fn(llr, t, **kw)
        torch.cuda.synchronize()
        ik = out_k[1]
        err = max_abs_diff(out_k, out_p)
        print(f"check {kname} {label}: B={B_STEP} max_abs_err={err}",
              flush=True)
        if err:
            fail(f"{kname} kernel != plain at B={B_STEP} ({label})")
        # The bound of this run's work: bytes in and out once, and the
        # operations of the iterations these words needed. The ADMM kernel
        # writes two planes: the decisions and the fractional x.
        planes = len(caps) if caps else (2 if is_admm else 1)
        n_bytes = B_STEP * (4 * code.get_n() * (1 + planes) + 4)
        if is_admm:
            g = code.graph
            updates, bracket_rows = admm_work(counts, ik, kw["max_iter"])
            n_ops = admm_ops(updates, bracket_rows, g.n_edge, g.n_var,
                             g.max_chk_deg)
            print(f"work {label}: {updates} updates, {bracket_rows} bracket "
                  f"rows of {updates * g.n_chk}", flush=True)
        else:
            n_ops = (int(ik.sum()) * code.graph.n_edge
                     * OPS_PER_EDGE_ITER[kname])
        bound = {"bytes": 1e3 * n_bytes / HBM_BYTES_PER_S,
                 "operations": 1e3 * n_ops / F32_OPS_PER_S}
        is_spa = kname.startswith("spa")
        if is_spa:
            phi_calls = 1 if kw["msg_dtype"] == bf16 else 2
            bound["sfu"] = (1e3 * int(ik.sum()) * code.graph.n_edge
                            * phi_calls * SFU_OPS_PER_PHI / sfu_per_s)
        bound_by = max(bound, key=bound.get)
        reps = {"kernel": 10 if caps else 20,
                "plain": 1 if caps or is_admm else 3}
        ms = {"kernel": [], "plain": [], "single": []}
        cws = {"kernel": [], "plain": []}
        for route in ("plain", "kernel", "kernel", "plain"):
            ms[route].append(time_decode(route_fn[route], llr, reps[route]))
            line = (f"timing {label} {route}: decode {ms[route][-1]:.4f} ms "
                    f"at B={B_STEP}")
            if caps:
                if route == "kernel":
                    ms["single"].append(time_decode(cuda_fn, llr,
                                                    reps[route], single_kw))
                    line += (f"; single-cap kernel at cap {caps[-1]} "
                             f"{ms['single'][-1]:.4f} ms")
            else:
                rate, wer = time_step(route_fn[route], reps[route])
                cws[route].append(rate)
                line += f"; whole step {rate:.1f} cw/s (wer {wer:.5f})"
            print(f"{line} | {card}", flush=True)
        best = {r: min(v) for r, v in ms.items() if v}
        line = (f"timing {label}: decode ms kernel {best['kernel']:.4f} vs "
                f"plain {best['plain']:.4f}")
        if caps:
            line += f" vs single-cap kernel {best['single']:.4f}"
        else:
            line += (f"; step cw/s kernel {max(cws['kernel']):.1f} vs plain "
                     f"{max(cws['plain']):.1f}")
        terms = ", ".join(f"{k} {v:.4f} ms" for k, v in bound.items())
        print(f"{line}; mean iterations {float(ik.float().mean()):.3f}; "
              f"bound {bound[bound_by]:.4f} ms by {bound_by} ({terms}) | "
              f"{card}", flush=True)
        # The special-function term is operations too, at their own rate.
        entry = {"ms": best["kernel"], "plain_ms": best["plain"],
                 "bound_ms": bound[bound_by],
                 "bound_by": "bytes" if bound_by == "bytes" else "operations",
                 "library_ms": None}
        if not is_spa or "2.5 dB" in label:
            time_geometries(kname, label, code_name, llr, kw, out_k)
        rule = rule_launch(kname, code_name, kw.get("msg_dtype"))
        entry["threads" if is_admm or is_spa else "geometry"] = rule
        print(f"launch geometry {label}: {rule} | {card}", flush=True)
        return entry

    msa_kw = dict(check_init=False, msg_dtype=bf16)
    ref_kw = dict(check_init=False, msg_dtype=bf16, inf_policy="reference")
    sat_kw = dict(check_init=False, msg_dtype=bf16, inf_policy="saturate")
    timed = {
        "msa_decode": time_case(
            "msa_decode", "msa bf16 biawgn 3.0 dB", FLAG, "biawgn", 3.0,
            dict(msa_kw, max_iter=10), 1),
        "spa_ref_decode": time_case(
            "spa_ref_decode", "spa reference bf16 biawgn 2.5 dB", FLAG,
            "biawgn", 2.5, dict(ref_kw, max_iter=10), 0),
        "spa_decode": time_case(
            "spa_decode", "spa saturate bf16 biawgn 2.5 dB", FLAG, "biawgn",
            2.5, dict(sat_kw, max_iter=10), 0),
        "bec_decode": time_case(
            "bec_decode", "erasure spa bec 0.375 cap 10", FLAG, "bec", 0.375,
            dict(max_iter=10), 0),
        "msa_decode_caps": time_case(
            "msa_decode", "msa caps K=7 bf16 biawgn 2.0 dB", FLAG, "biawgn",
            2.0, msa_kw, 1, caps=CAPS),
        "spa_ref_decode_caps": time_case(
            "spa_ref_decode", "spa reference caps K=7 bf16 biawgn 2.0 dB",
            FLAG, "biawgn", 2.0, ref_kw, 0, caps=CAPS),
        "spa_decode_caps": time_case(
            "spa_decode", "spa saturate caps K=7 bf16 biawgn 2.0 dB", FLAG,
            "biawgn", 2.0, sat_kw, 0, caps=CAPS),
        "bec_decode_caps": time_case(
            "bec_decode", "erasure spa caps K=7 bec 0.4", FLAG, "bec", 0.4,
            {}, 0, caps=CAPS),
    }
    time_case("spa_ref_decode", "spa reference f32 bsc 0.05", FLAG, "bsc",
              0.05, dict(max_iter=10, check_init=True, msg_dtype=f32,
                         inf_policy="reference"), 0)

    def time_spa_margulis():
        """margulis, biAWGN 2.25 dB, bf16, reference policy, B=16384: the
        kernel at the rule's thread count (held to the plain version at
        this shape) and under every entry of ``SPA_THREADS``."""
        _, t = tab("margulis")
        kw = dict(ref_kw, max_iter=10)
        llr = seeded_llr("margulis", "biawgn", 2.25, B_STEP, seed=3)
        want = spa_kernel.spa_decode_cuda(llr, t, **kw)
        if max_abs_diff(want, spa_kernel.spa_decode_plain(llr, t, **kw)):
            fail("spa_ref_decode kernel != plain on the margulis timing "
                 "batch")
        label = "spa reference bf16 margulis biawgn 2.25 dB"
        print(f"check spa_ref_decode {label}: B={B_STEP} max_abs_err=0; "
              f"rule {rule_launch('spa', 'margulis', bf16)} threads "
              f"per word; mean iterations {float(want[1].float().mean()):.3f}",
              flush=True)
        time_geometries("spa_ref_decode", label, "margulis", llr, kw, want)

    time_spa_margulis()
    timed["admm_decode"] = time_case(
        "admm_decode", "admm biawgn 2.5 dB cap 50", FLAG, "biawgn", 2.5,
        admm_kw(FLAG, 50), 1)

    def time_margulis():
        """margulis BSC p=0.07, converge mode: the kernel at B=2048, and
        on the first 128 words of that batch the plain version beside the
        kernel (where the two are also held equal). ``plain_ms`` is the
        128-word time as measured: the plain version is bound by launches
        there, so it is not scaled to the larger batch."""
        code, t = tab("margulis")
        g = code.graph
        kw = admm_kw("margulis", MAR_CAP)
        llr = seeded_llr("margulis", "bsc", 0.07, B_MAR, seed=3, codeword=1)
        head = llr[:B_MAR_PLAIN].contiguous()
        kernel = admm_kernel.admm_decode_cuda
        runs = {"kernel": (kernel, llr),
                "plain": (admm_kernel.admm_decode_plain, head),
                "kernel_head": (kernel, head)}

        def timed_once(fn, inp):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(inp, t, **kw)
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop), out

        kernel(head, t, **kw)                             # warm-up
        ms = {route: [] for route in runs}
        out = {}
        with bracket_counts() as counts:
            out["plain"] = timed_once(*runs["plain"])[1]    # counted, not timed
        for route in ("plain", "kernel", "kernel_head", "kernel",
                      "kernel_head", "plain"):
            dt, out[route] = timed_once(*runs[route])
            ms[route].append(dt)
            print(f"timing admm margulis bsc 0.07 converge {route}: decode "
                  f"{dt:.4f} ms at B={runs[route][1].shape[0]} | {card}",
                  flush=True)
        for route in ("kernel", "kernel_head"):
            if max_abs_diff([o[:B_MAR_PLAIN] for o in out[route]],
                            out["plain"]):
                fail("admm_decode kernel != plain on the first words of "
                     "the margulis timing batch")
        iters = out["kernel"][1]
        updates = int((iters + (iters < MAR_CAP)).sum())
        # The share of rows that need the bracket search, as counted on
        # the plain version's run over the first words.
        head_updates, head_rows = admm_work(counts, out["plain"][1], MAR_CAP)
        share = head_rows / (head_updates * g.n_chk)
        n_ops = admm_ops(updates, share * updates * g.n_chk, g.n_edge,
                         g.n_var, g.max_chk_deg)
        n_bytes = B_MAR * (4 * g.n_var * 3 + 4)
        bound = {"bytes": 1e3 * n_bytes / HBM_BYTES_PER_S,
                 "operations": 1e3 * n_ops / F32_OPS_PER_S}
        bound_by = max(bound, key=bound.get)
        best = {route: min(v) for route, v in ms.items()}
        it_f = iters.float()
        print(f"timing admm margulis bsc 0.07 converge: decode ms kernel "
              f"{best['kernel']:.4f} at B={B_MAR}; at B={B_MAR_PLAIN} kernel "
              f"{best['kernel_head']:.4f} vs plain {best['plain']:.4f}; "
              f"iterations mean {float(it_f.mean()):.3f} median "
              f"{float(it_f.median()):.1f}, at the bound of {MAR_CAP} "
              f"{float((iters >= MAR_CAP).float().mean()):.4f} of words, wer "
              f"{float((out['kernel'][0] != 1).any(dim=1).float().mean()):.5f}"
              f"; bracket rows {share:.4f} of rows; bound "
              f"{bound[bound_by]:.4f} ms by {bound_by} (bytes "
              f"{bound['bytes']:.4f} ms, operations "
              f"{bound['operations']:.4f} ms) | {card}", flush=True)
        label = "admm margulis bsc 0.07 converge"
        time_geometries("admm_decode", label, "margulis", llr, kw,
                        out["kernel"])
        time_geometries("admm_decode", label, "margulis", head, kw,
                        out["kernel_head"])
        return {"ms": best["kernel"], "batch": B_MAR,
                "plain_ms": best["plain"], "plain_batch": B_MAR_PLAIN,
                "ms_at_plain_batch": best["kernel_head"],
                "bound_ms": bound[bound_by], "bound_by": bound_by,
                "library_ms": None,
                "threads": rule_launch("admm", "margulis")}

    timed["admm_decode_margulis"] = time_margulis()

    csrc = "ldpc_decoders_tpu_torch/csrc/"
    pallas = "ldpc_decoders_tpu/ops/pallas_bp.py:"
    sources = {"msa_decode": ("msa_decode.cu", "339"),
               "spa_decode": ("spa_decode.cu", "710"),
               "spa_ref_decode": ("spa_decode.cu", "838"),
               "bec_decode": ("bec_decode.cu", "565"),
               "admm_decode": ("admm_decode.cu", "1172"),
               "admm_decode_margulis": ("admm_decode.cu", "1189")}
    lines = []
    for k in knames:
        if launches[k] < 1:
            fail(f"no main path launched {k}")
        src, line = sources[k.removesuffix("_caps")]
        lines.append({"name": k, "route": "cuda", "source": csrc + src,
                      "replaces": pallas + line, "launches": launches[k],
                      "max_abs_err": max_err[k], **timed[k]})
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
