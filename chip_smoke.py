"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: a CUDA device must be present (there is no CPU fallback); the
   card's name and power limit as nvidia-smi reports them.
2. Build: the seven kernel sources (``ldpc_decoders_tpu_torch/csrc``:
   ``msa_decode.cu``, ``spa_decode.cu``, ``bec_decode.cu``,
   ``admm_decode.cu``, ``lt_peel.cu``, ``admm_step.cu``, ``mlp_fused.cu``)
   compile here, in parallel.
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
6. LT fountain, at the golden curves' configuration (k=10000, n=12000,
   delta=0.5, c in 0.01, 0.03, 0.1; ``fountain/lt.py``):
   (a) the peel kernel (``lt_peel_cuda``) against the plain sparse engine
   (``lt_peel_plain``) on the same sampled tables: ``result`` and
   ``resolved`` equal, ``est`` equal where resolved, at (k, n) = (40, 46)
   (some sims must fail) and (60, 120), 24 sims each at c=0.1, and 16
   golden-scale sims per c; on each, the kernel's own edge layout
   (``lt_layout_cuda``: its counting sort) held to ``edge_layout``: the
   offsets equal, each variable's symbols the same multiset; (b) the dense
   engine (``torch.bmm`` rounds) equal to the kernel on the first 4 of
   those per c, with its time and peak memory; the host's time per sim for
   the light lists and for the sorted tables, and the kernel's layout on
   the card;
   (c) the CLI (``fountain.lt.main``) end to end, 128 sims per c at
   ``--batch 64``: its Saver file has the artifact's name, and its mean
   and std lie within 4 standard errors (the std's kurtosis-adjusted, as
   in ``tests/test_lt.py``) of ``artifacts/data/luby-10000-12000-<c>-0.5
   .json``; s/sim end to end, the sampler's s/sim, CUDA events around each
   batch's ``simulate`` and the device's idle share from them; at c=0.03
   one ``torch.profiler`` window around the CLI's last batch, run again
   through ``LTSimulator.simulate`` after the timed run: the device time
   of a batch (its copy and the kernel) apart from the GIL gaps that the
   events take in while the sampler thread runs; on the CLI's
   last batch of each c the kernel (CUDA events over 5 launches), its
   layout alone (``layout_ms``; the peel is the difference), the plain
   sparse engine and the dense engine, the kernel held equal to both and
   its tables to ``edge_layout``'s. The dense engine runs the whole batch
   of 64 at c=0.03 only, and its first 4 sims at 0.01 and 0.1. The
   ``kernels`` entry gives c=0.03, and ``by_c`` all three: ``library_ms``
   is the dense engine's time on the whole batch (the same function
   through ``torch.bmm``; null where it ran on 4 sims), ``bound_ms`` the
   bytes of the real edges' two lists and the messages read once and of
   the outputs written once over 3.35 TB/s; the kernel's ripples (one,
   plus one per prefix jump) are printed beside it.

7. ADMMA and the plots (``decoders/admma.py``). On the card ADMMA's loop
   runs on its own kernels: per loop iteration K1 ``admm_iter_pre`` (the
   x-update and the rows v), then K2 ``project_rows`` (the exact
   projection) and K4 ``mlp_train`` (the fused MLP's forward, loss and
   gradients, then ``torch.optim.Adam``'s update) in train mode, or K4
   ``mlp_forward`` in eval mode (K2 after the ``apprx`` window), then K3
   ``admm_iter_post`` (dual update, norms, freeze, the count of the words
   left); K1-K3 are ``csrc/admm_step.cu``, K4 ``csrc/mlp_fused.cu``. Each
   main path below runs with those kernels' counts set to 0 just before it
   and read just after, and with every plain version of them (the plain
   ADMM loop and its halves, ``project_parity_polytope``, the plain MLP
   and its autograd pass) patched to raise:
   (a) at the CLI's width (layers [100, 100]) on LDPC(1200,3,6), biAWGN
   2.5 dB, codeword 1, cap 50, B=4096: train mode equal to the ADMM kernel
   ``csrc/admm_decode.cu`` bit for bit in x_hat, iterations and fractional
   x, its parameters moved; its decode time and peak memory. On (a)'s first
   iteration (z = 0.5, lam = 0, the MLP's seeded start; 2,457,600 rows):
   K1, K2 and K3 bit-equal to their plain versions, K4's forward within
   1e-5 abs of the plain MLP, its loss and every gradient within 1e-5
   relative (norm of the difference over the plain one's) of autograd's,
   and the same bits on a second run; each kernel's time beside its plain
   version's, Adam's update, and the whole iteration (PR 10's plain loop:
   26.317 ms); TF32 must be off. K3 also on the state after 36 loop
   iterations of the exact loop on (a)'s words, most of them frozen:
   bit-equal to its plain version, its time beside the bound of the running
   words' bytes;
   (b) offline training: dim 4 [64, 64], 1500 steps of 512, MSE < 5e-3
   against the exact projection on 256 held-out rows; dim 6 [100, 100],
   2000 steps of 1024 (a main path: K2 and K4), its loss; steps/s of both;
   (c) eval mode with the dim-4 model on the Hamming(7,4) codebook (BSC
   0.05): at least 75% of words, and all of them with ``apprx=3`` and
   ``iter_cap=500``; on (a)'s input with the committed
   ``cache/model_6-100-100-6.npz`` the eval decode's rate, held against
   the plain route (the plain loop and the plain MLP on the card) on the
   same input: decisions equal on at least 99.9% of words, the differing
   words printed;
   (d) the CLI: ``main biawgn 1200_3_6_ldpc ADMMA --train`` and ``... ADMM``
   at the same seed, points (2.75 and 3.0 dB) and ``--max-iter 50``: the
   runner gives both the same pipeline rule and generator draws, so their
   Saver files' tot, wec, wer, bec, ber and iteration histograms must be
   equal; the ADMMA run launches K1, K2, K3 and K4's training pass and no
   ``admm_decode``, the ADMM run ``admm_decode`` (counted in its ``kernels``
   entry); ``main ... ADMMA`` in eval mode with the committed model
   (16384 words a point) launches K1, K3 and K4's forward;
   (e) the polytope demos' projections on the card (K2) equal the CPU's
   within 1e-6, and ``viz.cases HMG`` draws its six figures from
   ``artifacts/data``; where matplotlib is not installed, each figure's
   curves (files, labels, points) go through the same selection and plot
   functions into a recorder and are checked, and nothing is drawn.
   The ``kernels`` entries of K1-K4: ``ms`` and ``plain_ms`` on (a)'s first
   iteration (CUDA events, best of three), ``bound_ms`` from that input's
   bytes (each plane in and out once) and operations (K2: the rows that
   need the bracket search, counted; K4: two per multiply-add of its
   products, three times over at the tensor cores' TF32 rate, 495
   TFLOP/s, as its split-TF32 products run, with the float32 FFMA term
   printed beside it), ``library_ms`` null (no single PyTorch call
   computes any of them); ``launches`` over phase 7's main paths and phase
   8 (e)'s ranks.

8. Several ranks (``parallel/``: one process per rank over
   ``torch.distributed``). Without a card per rank the ranks share the card
   over gloo (``spawn(..., backend="gloo")``). Two ranks, in one spawn:
   (a) the flagship at full width, LDPC(1200,3,6) biAWGN MSA bf16 at 2.5
   and 3.0 dB, codeword 1, global B = 16384 (8192 words a rank): each
   point's summed tallies must equal, word for word, the sum of
   single-process replays of each rank's stream at B = 8192, chunk for
   chunk, for the chunks the mesh run took; ``msa_decode.cu`` must launch
   in each rank; the step's cw/s at 3.0 dB over 4,194,304 words at one rank
   (before and after the spawn) and, twice, at two ranks (the tally summed
   on the host at consume, gloo's design); (b) ADMM at 2.5 dB, cap 50,
   B = 16384: the same exact replay, the 2000-bin histogram included; (c) REG_ENS biAWGN SPA bf16 2.0 dB over its
   first two members, rotating (B = 16384) and joint (2048 per member):
   the same replay per member; (d) the edge-sharded decoder
   (``EdgeShardedBPDecoder``, a 2-rank ``code`` mesh) on LDPC(1200,3,6)
   and margulis, MSA and SPA under both policies, biAWGN 2.0 dB, B = 4096,
   cap 10: against ``BPDecoder``'s f32 kernel on the same LLRs at most one
   word may differ, and with none the iteration counts must be equal; its
   ms beside the kernel's; then the harness on a 1 x 2 code mesh (margulis
   MSA 2.0 dB, B = 4096) and, in a spawn of four ranks, on a 2 x 2 batch x
   code mesh (LDPC(1200,3,6) BSC MSA p=0.035), each WER within 6 SE of one
   rank's; (e) ADMMA train, B = 4096, layers [100, 100], 2.5 dB cap 50:
   each rank launches K1, K2, K3 and K4's training pass, the MLPs
   bit-equal on both ranks and moved from their start, WER within 6 SE of
   one rank; (f) the luby CLI with ``--mesh 2`` at c = 0.03, 128
   sims, ``--batch 64``: ``arr`` equals the rank-ordered concatenation of
   each rank's stream replayed alone, and its mean and std lie within 4 SE
   of the artifact as in phase 6; s/sim at one rank (phase 6) and at two,
   and the device's idle share (CUDA events around each batch's
   ``simulate`` in each rank, as phase 6 times one process); (g) with two
   cards or more, (a) and its two timed runs again over NCCL, a card per
   rank (the tally summed on the card at dispatch, NCCL's design); else
   the phase says that NCCL was not run; (h) the cap sweep
   (``CapSweepRunner``, REG_BAD's labels) on LDPC(1200,3,6) biAWGN MSA
   bf16 2.0 dB, codeword 1, B = 16384, 64 chunks (1,048,576 words): every
   label's summed tallies equal the replays, and ``msa_decode.cu``'s
   ``caps=`` form launches in each rank; its seconds beside one rank's. Every rank must import no jax, and the ranks must hold the same
   results.

The ``kernels`` line gives each kernel's ``bound_ms``: the larger of the
bytes it must move (input read once, K output planes and the iteration
counts written once) over 3.35 TB/s, and its operations over 67 TFLOP/s
(the float32 rate outside the tensor cores; the erasure kernel's integer
operations are held to the same rate; K4, whose products run on the
tensor cores in split TF32, three TF32 products per multiply-add over 495
TFLOP/s); for the SPA kernels also their
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
# K4 (csrc/mlp_fused.cu) runs its float32 products on the tensor cores in
# split TF32: three TF32 products per multiply-add, at the card's dense
# TF32 rate.
TF32_OPS_PER_S = 495e12
SPLIT_TF32_PRODUCTS = 3
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
# LT fountain: the golden curves' configuration (k, n, delta; each c) and
# the phase's sizes.
LT_K, LT_N, LT_DELTA = 10000, 12000, 0.5
LT_CS = ("0.01", "0.03", "0.1")
LT_SMALL = ((40, 46, 24), (60, 120, 24))   # (k, n, sims) at c = 0.1
LT_GOLDEN_SIMS = 16
LT_DENSE_SIMS = 4
LT_CLI_SIMS = 128
LT_BATCH = 64
LT_KEYS = ("edge_sym", "edge_var", "msg")
# ADMMA (phase 7): the CLI's MLP width and the cap of its run.
ADMMA_LAYERS = [100, 100]
ADMMA_CAP = 50
# K3's second input: the state after this many loop iterations.
ADMMA_FROZEN_ITERS = 36
# Several ranks (phase 8): ranks, the flagship's points and min-wec (several
# chunks of 16384 at 3.0 dB), the words of each timed flagship run, the
# edge-sharded batch, and the min-wec of the REG_ENS members (two chunks of
# 16384 at WER ~0.34).
MESH_RANKS = 2
MESH_FLAG_PARAMS = [2.5, 3.0]
MESH_FLAG_MIN_WEC = 5000
MESH_RATE_WORDS = 256 * B_STEP
MESH_CAPS_WORDS = 64 * B_STEP
MESH_EDGE_B = 4096
MESH_ENS_MIN_WEC = 8000


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

def kurtosis_var_of_std(arr) -> float:
    """Kurtosis-adjusted Var(s) of a sample's standard deviation by the
    delta method: Var(s^2) = (mu4 - s^4 (n-3)/(n-1)) / n, Var(s) ~
    Var(s^2) / (4 s^2). The LT symbol counts have a heavy upper tail
    (sample kurtosis ~9-10), so the normal-theory s/sqrt(2n) is too tight."""
    import numpy as np

    n = arr.size
    s2 = arr.var()
    mu4 = ((arr - arr.mean()) ** 4).mean()
    return max((mu4 - s2 ** 2 * (n - 3) / (n - 1)) / n, 0.0) / (4 * s2)


def lt_phase(card: str) -> tuple:
    """Phase 6, the LT fountain path at the golden curves' configuration.
    Returns the ``kernels``-line entry of ``lt_peel`` and its launches on
    the CLI runs."""
    import numpy as np
    import torch

    from ldpc_decoders_tpu_torch.fountain import lt
    from ldpc_decoders_tpu_torch.ops import lt_kernel

    dev = torch.device("cuda")
    kernel, plain = lt_kernel.lt_peel_cuda, lt_kernel.lt_peel_plain

    def on_card(t):
        return [t[key].to(dev) for key in LT_KEYS]

    def differs(a, b):
        """Results, resolved sets, and recovered bits where resolved."""
        return not (torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
                    and torch.equal(a[1][a[2]], b[1][b[2]]))

    def hold_tables(args, n, label):
        """The kernel's own layout (counting sort) == ``edge_layout``."""
        tables = lt_kernel.lt_layout_cuda(*args, n)
        if not lt_kernel.layout_matches(tables, args[0], args[1], n):
            fail(f"lt_peel's edge layout != edge_layout {label}")

    def timed(fn, *args, reps=1):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn(*args)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps, out

    def dense_run(k, n, c, tables):
        dense = lt.LTSimulator(k, n, float(c), LT_DELTA, engine="dense",
                               device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms, out = timed(dense.simulate, tables)
        peak = torch.cuda.max_memory_allocated()
        del dense
        torch.cuda.empty_cache()
        return ms, out, peak

    # (a) the kernel == the plain sparse engine, its tables == edge_layout's,
    # and (b) the dense engine.
    cases = [(k, n, "0.1", sims) for k, n, sims in LT_SMALL]
    cases += [(LT_K, LT_N, c, LT_GOLDEN_SIMS) for c in LT_CS]
    for i, (k, n, c, sims) in enumerate(cases):
        sim = lt.LTSimulator(k, n, float(c), LT_DELTA, device=dev)
        t0 = time.perf_counter()
        args = on_card(sim.sample_batch(np.random.default_rng(100 + i), sims))
        sample_s = time.perf_counter() - t0
        ms_k, out_k = timed(kernel, *args, n)
        ms_p, out_p = timed(plain, *args, n)
        if differs(out_k, out_p):
            fail(f"lt_peel kernel != plain sparse engine at k={k} n={n} c={c}")
        hold_tables(args, n, f"at k={k} n={n} c={c}")
        res = out_k[0]
        n_fail = int((res == n).sum())
        print(f"check lt_peel k={k} n={n} c={c}: {sims} sims equal "
              f"(result, resolved, est where resolved), tables == "
              f"edge_layout; failures {n_fail}; mean result "
              f"{float(res.float().mean()):.1f}; kernel ripples max "
              f"{int(out_k[3].max())}, plain rounds max "
              f"{int(out_p[3].max())}; kernel {ms_k:.3f} ms, plain "
              f"{ms_p:.3f} ms, sampling {sample_s / sims:.4f} s/sim | {card}",
              flush=True)
        if n == 46 and not n_fail:
            fail("no sim failed at (k, n) = (40, 46): the failure path ran "
                 "nowhere")
        if k != LT_K:
            continue
        head = dict(zip(LT_KEYS, (a[:LT_DENSE_SIMS] for a in args)))
        ms_d, out_d, peak = dense_run(k, n, c, head)
        if differs(out_d, [x[:LT_DENSE_SIMS] for x in out_k[:3]]):
            fail(f"dense engine != lt_peel kernel at c={c}")
        print(f"check lt dense engine c={c}: {LT_DENSE_SIMS} sims == kernel; "
              f"{ms_d:.3f} ms, peak memory {peak / 2**30:.3f} GiB | {card}",
              flush=True)

    # The edge tables: sorted on the host (sample_edges without light)
    # against the light lists plus the kernel's own layout on the card.
    sim = lt.LTSimulator(LT_K, LT_N, 0.03, LT_DELTA, device=dev)
    host = {}
    for light in (True, False):
        rng = np.random.default_rng(7)
        t0 = time.perf_counter()
        for _ in range(4):
            lt.sample_edges(rng, sim.omega, LT_K, LT_N, sim.e_pad, light=light)
        host[light] = (time.perf_counter() - t0) / 4
    args = on_card(sim.sample_batch(np.random.default_rng(8), LT_BATCH))
    lt_kernel.lt_layout_cuda(*args, LT_N)
    ms_layout = min(timed(lt_kernel.lt_layout_cuda, *args, LT_N)[0]
                    for _ in range(3))
    print(f"lt edge tables: host sampler {host[True]:.4f} s/sim light, "
          f"{host[False]:.4f} s/sim with the sorted tables (+"
          f"{host[False] - host[True]:.4f}); the kernel's layout on the card "
          f"{ms_layout:.3f} ms per batch of {LT_BATCH} | {card}", flush=True)

    # (c) the CLI end to end, 128 sims per c; then the kernel, its layout
    # alone, the plain sparse engine and the dense engine on its last batch,
    # and at c=0.03 that batch once more through the simulator inside one
    # torch.profiler window.
    real_sample, real_simulate = lt.LTSimulator.sample_batch, \
        lt.LTSimulator.simulate
    launches, entries = 0, {}
    for c in LT_CS:
        stats = {"sample_s": 0.0, "events": [], "tables": None}

        def sample(self, rng, batch):
            t0 = time.perf_counter()
            out = real_sample(self, rng, batch)
            stats["sample_s"] += time.perf_counter() - t0
            stats["tables"] = out
            return out

        def simulate(self, tables):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real_simulate(self, tables)
            stop.record()
            stats["events"].append((start, stop))
            return out

        argv = [str(LT_K), str(LT_N), c, str(LT_DELTA), str(LT_CLI_SIMS),
                "--batch", str(LT_BATCH), "--console"]
        artifact = f"luby-{LT_K}-{LT_N}-{c}-{LT_DELTA}.json"
        with tempfile.TemporaryDirectory() as tmp:
            lt.LTSimulator.sample_batch, lt.LTSimulator.simulate = sample, \
                simulate
            try:
                kernel.launches = 0
                t0 = time.perf_counter()
                lt.main(argv + ["--data_dir", tmp])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n_launch = kernel.launches
            finally:
                lt.LTSimulator.sample_batch = real_sample
                lt.LTSimulator.simulate = real_simulate
            files = os.listdir(tmp)
            if files != [artifact]:
                fail(f"LT CLI c={c} wrote {files}, not [{artifact}]")
            with open(os.path.join(tmp, artifact)) as fp:
                saved = json.load(fp)
        if n_launch < 1:
            fail(f"the LT CLI at c={c} did not launch lt_peel")
        launches += n_launch
        ours = np.array(saved["arr"], float)
        with open(os.path.join(ARTIFACTS, artifact)) as fp:
            ref = np.array(json.load(fp)["arr"], float)
        if ours.size != LT_CLI_SIMS or not ((ours >= LT_K) & (ours <= LT_N)).all():
            fail(f"LT CLI c={c}: {ours.size} results, or some outside [k, n]")
        se = math.sqrt(ref.var() / ref.size + ours.var() / ours.size)
        se_s = math.sqrt(kurtosis_var_of_std(ref) + kurtosis_var_of_std(ours))
        z_m = (ours.mean() - ref.mean()) / se
        z_s = (ours.std() - ref.std()) / se_s
        busy = sum(a.elapsed_time(b) for a, b in stats["events"]) / 1e3
        batch_ms = [a.elapsed_time(b) for a, b in stats["events"]]
        print(f"cli lt {' '.join(argv)}: {wall:.3f} s, lt_peel launches="
              f"{n_launch}; mean {ours.mean():.1f} std {ours.std():.1f} vs "
              f"artifact {ref.mean():.1f} / {ref.std():.1f} ({ref.size} "
              f"sims): z mean {z_m:.3f}, z std {z_s:.3f}", flush=True)
        print(f"timing lt cli c={c}: {wall / LT_CLI_SIMS:.4f} s/sim end to "
              f"end, sampler {stats['sample_s'] / LT_CLI_SIMS:.4f} s/sim, "
              f"events per batch (copy, kernel; GIL gaps included) "
              f"{', '.join(f'{x:.3f}' for x in batch_ms)} ms, device idle "
              f"{1 - busy / wall:.4f} of the wall time | {card}", flush=True)
        if not (abs(z_m) < 4 and abs(z_s) < 4):
            fail(f"LT CLI c={c}: mean or std more than 4 SE from {artifact}")
        profiled = None
        if c == "0.03":
            # The device time of a CLI batch (the pinned tables' copy and
            # the kernel), apart from the GIL gaps that the events above
            # take in while the sampler thread runs: the profiler's first
            # start takes seconds, so not inside the timed run.
            sim = lt.LTSimulator(LT_K, LT_N, float(c), LT_DELTA, device=dev)
            sim.simulate(stats["tables"])
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                sim.simulate(stats["tables"])
                torch.cuda.synchronize()
            rows = {}
            for ev in prof.key_averages():
                dev_us = getattr(ev, "device_time_total",
                                 getattr(ev, "cuda_time_total", 0.0))
                if dev_us > 0 and \
                        ev.device_type == torch.autograd.DeviceType.CUDA:
                    rows[ev.key] = rows.get(ev.key, 0.0) + dev_us / 1e3
            if not any("lt_peel" in key for key in rows):
                fail("the profiler window saw no lt_peel kernel on the card")
            profiled = sum(rows.values())
            print(f"profile lt cli c={c}, its last batch again through "
                  f"LTSimulator.simulate: device time {profiled:.4f} ms (" +
                  ", ".join(f"{key[:40]} {ms:.4f}" for key, ms in sorted(
                      rows.items(), key=lambda r: -r[1])) +
                  f"); events around the CLI's batches "
                  f"{', '.join(f'{x:.3f}' for x in batch_ms)} ms | {card}",
                  flush=True)

        # The last CLI batch: the kernel (with its layout, and the layout
        # alone), the plain and the dense engine; the kernel held to both
        # and its tables to edge_layout's. The dense engine takes the whole
        # batch at c=0.03 and its first LT_DENSE_SIMS sims elsewhere.
        args = on_card(stats["tables"])
        kernel(*args, LT_N)
        lt_kernel.lt_layout_cuda(*args, LT_N)
        ms_k, out_k = timed(kernel, *args, LT_N, reps=5)
        ms_lay = timed(lt_kernel.lt_layout_cuda, *args, LT_N, reps=5)[0]
        ms_p, out_p = timed(plain, *args, LT_N)
        hold_tables(args, LT_N, f"on the CLI batch at c={c}")
        B = args[0].shape[0]
        dense_b = B if c == "0.03" else LT_DENSE_SIMS
        ms_d, out_d, peak = dense_run(
            LT_K, LT_N, c, dict(zip(LT_KEYS, (a[:dense_b] for a in args))))
        if differs(out_k, out_p) or differs(out_d,
                                            [x[:dense_b] for x in out_k[:3]]):
            fail(f"lt_peel != plain or dense on the CLI batch at c={c}")
        # The bound: the edge lists of the real edges, the messages read
        # once; result, est (int32) and resolved (bool) written once.
        edges = int((args[0] < LT_N).sum())
        n_bytes = 8 * edges + B * (4 * LT_K + 4 + 5 * LT_K)
        bound = 1e3 * n_bytes / HBM_BYTES_PER_S
        ripples = out_k[3]
        print(f"timing lt_peel c={c} B={B}: kernel {ms_k:.4f} ms (its "
              f"layout {ms_lay:.4f} ms alone, the peel {ms_k - ms_lay:.4f}),"
              f" plain {ms_p:.3f} ms, dense (torch.bmm) on {dense_b} sims "
              f"{ms_d:.3f} ms peak {peak / 2**30:.3f} GiB; bound "
              f"{bound:.4f} ms by bytes ({edges} edges); ripples per sim max "
              f"{int(ripples.max())} mean {float(ripples.float().mean()):.1f} "
              f"| {card}", flush=True)
        entries[c] = {"ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
                      "bound_by": "bytes",
                      "library_ms": ms_d if dense_b == B else None,
                      "layout_ms": ms_lay, "peel_ms": ms_k - ms_lay,
                      "batch": B, "dense_sims": dense_b, "dense_ms": ms_d,
                      "ripples_max": int(ripples.max()),
                      "cli_s_per_sim": wall / LT_CLI_SIMS,
                      "cli_idle": 1 - busy / wall,
                      "profiled_batch_ms": profiled}
    return dict(entries["0.03"], c=0.03, by_c=entries), launches


# kernel name of ADMMA's loop -> (its wrapper module, the wrapper's name)
ADMMA_KERNELS = {"admm_iter_pre": ("admm_step", "admm_iter_pre_cuda"),
                 "project_rows": ("admm_step", "project_rows_cuda"),
                 "admm_iter_post": ("admm_step", "admm_iter_post_cuda"),
                 "mlp_forward": ("mlp_kernel", "mlp_forward_cuda"),
                 "mlp_train": ("mlp_kernel", "mlp_train_cuda")}


def admma_wrappers() -> dict:
    """Kernel name -> the wrapper whose ``launches`` counts it."""
    import importlib

    return {k: getattr(importlib.import_module(
        f"ldpc_decoders_tpu_torch.ops.{mod}"), fn)
        for k, (mod, fn) in ADMMA_KERNELS.items()}


@contextlib.contextmanager
def plain_forbidden():
    """While open, the plain versions of ADMMA's kernels (the plain ADMM
    loop and its halves, the plain projection, the plain MLP and its
    autograd pass) raise wherever a module of the port binds them."""
    from ldpc_decoders_tpu_torch.ops import admm_kernel, mlp_kernel, projection

    plain = (admm_kernel.admm_decode_plain, admm_kernel.admm_iter_pre_plain,
             admm_kernel.admm_iter_post_plain,
             projection.project_parity_polytope,
             mlp_kernel.mlp_forward_plain, mlp_kernel.mlp_train_plain)
    saved = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith(
                "ldpc_decoders_tpu_torch"):
            continue
        for name, val in list(vars(mod).items()):
            if any(val is f for f in plain):
                def forbidden(*args, _name=name, **kw):
                    raise RuntimeError(f"the card route called the plain "
                                       f"{_name}")
                saved.append((mod, name, val))
                setattr(mod, name, forbidden)
    try:
        yield
    finally:
        for mod, name, val in saved:
            setattr(mod, name, val)


@contextlib.contextmanager
def counted(launches: dict, label: str, need=()):
    """Runs one main path with ADMMA's kernel counts set to 0 just before
    it, adds the counts read just after to ``launches``, and fails unless
    every kernel in ``need`` launched."""
    wrappers = admma_wrappers()
    for w in wrappers.values():
        w.launches = 0
    yield
    got = {k: w.launches for k, w in wrappers.items()}
    for k in need:
        if got[k] < 1:
            fail(f"{label} did not launch {k}")
    for k, n in got.items():
        launches[k] = launches.get(k, 0) + n
    print(f"launches {label}: " + ", ".join(f"{k} {n}" for k, n in
                                             got.items()), flush=True)


def mlp_flops(sizes, rows: int, train: bool) -> int:
    """Multiply-adds as two operations: the forward's products, and in
    training the weight gradients' and the hidden gradients' (none for
    the input)."""
    prods = [a * b for a, b in zip(sizes[:-1], sizes[1:])]
    n = sum(prods)
    if train:
        n = 3 * n - prods[0]
    return 2 * rows * n


def admma_phase(card: str) -> tuple:
    """Phase 7, ADMMA and the plots. Returns the ``admm_decode`` launches
    of the ADMM CLI run in (d), and per kernel of ADMMA's loop its launches
    on the phase's main paths and its ``kernels``-line numbers."""
    import numpy as np
    import torch

    from ldpc_decoders_tpu_torch import main as cli
    from ldpc_decoders_tpu_torch.channels import CHANNELS
    from ldpc_decoders_tpu_torch.codes import get_code
    from ldpc_decoders_tpu_torch.decoders import admma
    from ldpc_decoders_tpu_torch.decoders.admm import ADMMDecoder
    from ldpc_decoders_tpu_torch.ops import admm_kernel, admm_step, mlp_kernel
    from ldpc_decoders_tpu_torch.ops.projection import (
        project_parity_polytope,
    )
    from ldpc_decoders_tpu_torch.utils.math import pseudo_to_cw_tensor

    dev = torch.device("cuda")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        fail("TF32 is enabled for float32 matmuls: ADMMA's MLP must run in "
             "true float32")

    def events(fn, reps=1):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps, out

    def best_ms(fn, reps=5):
        fn()
        return min(events(fn, reps)[0] for _ in range(3))

    code = get_code(FLAG)
    g_flag = code.graph
    gen = torch.Generator(device=dev).manual_seed(77)
    x = torch.ones((B_CHECK, code.get_n()), dtype=torch.int32, device=dev)
    llr = CHANNELS["biawgn"].llr(CHANNELS["biawgn"].send(x, 2.5, gen), 2.5)
    kw = dict(mu=3.0, eps=1e-5, max_iter=ADMMA_CAP)
    launches = {}
    need_train = ("admm_iter_pre", "project_rows", "admm_iter_post",
                  "mlp_train")
    need_eval = ("admm_iter_pre", "admm_iter_post", "mlp_forward")

    with tempfile.TemporaryDirectory() as cache:
        # (a) train mode == the ADMM kernel, bit for bit, on the kernels.
        ref = ADMMDecoder(g_flag, device=dev, **kw)
        t = ref.tables
        want = admm_kernel.admm_decode_cuda(llr, t, n_edge=g_flag.n_edge,
                                            **kw)
        got = {}
        for pseudo in (False, True):
            dec = admma.ADMMADecoder(g_flag, layers=ADMMA_LAYERS,
                                     train=True, allow_pseudo=pseudo,
                                     cache_dir=cache, device=dev, **kw)
            w0 = dec.mlp.w1.detach().clone()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with plain_forbidden(), counted(
                    launches, f"admma train decode (pseudo={pseudo})",
                    need_train):
                t0 = time.perf_counter()
                got[pseudo] = dec.decode(llr)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            if torch.equal(w0, dec.mlp.w1):
                fail("ADMMA train mode did not move its parameters")
        x_hat, iters = got[False]
        frac = pseudo_to_cw_tensor(want[2], True)
        if not (torch.equal(x_hat, want[0]) and torch.equal(iters, want[1])
                and torch.equal(got[True][0], frac)
                and torch.equal(got[True][1], want[1])):
            fail("ADMMA train mode != the admm_decode kernel at "
                 f"{ADMMA_LAYERS}, B={B_CHECK}")
        n_loop = int(iters.max()) + (int(iters.max()) < ADMMA_CAP)
        rows_b = B_CHECK * g_flag.n_chk
        print(f"check admma train == admm_decode kernel, {FLAG} biawgn 2.5 dB "
              f"cap {ADMMA_CAP} layers {ADMMA_LAYERS}: B={B_CHECK} x_hat, "
              f"iters and fractional x bit-equal; mean iterations "
              f"{float(iters.float().mean()):.3f}, loop iterations (Adam "
              f"steps) {n_loop}; wer "
              f"{float((x_hat != 1).any(dim=1).float().mean()):.5f}; decode "
              f"{secs:.3f} s = {B_CHECK / secs:.1f} cw/s (PR 14: 12,607.6); "
              f"peak memory "
              f"{peak / 2**30:.3f} GiB ({rows_b} rows) | {card}", flush=True)

        # Each kernel of the loop against its plain version on (a)'s
        # first iteration: z = 0.5, lam = 0, the MLP's seeded start.
        st = admm_step.step_tables(t)
        C, Dc = t.chk_var.shape
        inv_mu = admm_kernel._inv_mu(3.0)
        thresh = admm_kernel._threshold(1e-5, g_flag.n_edge)
        inv_mu_t = torch.tensor(inv_mu, device=dev)
        z = torch.full((B_CHECK, C, Dc), 0.5, device=dev)
        lam = torch.zeros_like(z)
        g = llr * inv_mu_t
        x0 = torch.zeros_like(g)
        upd0 = torch.zeros(B_CHECK, dtype=torch.int32, device=dev)
        done0 = torch.zeros(B_CHECK, dtype=torch.bool, device=dev)
        mlp = admma.mlp_init(Dc, ADMMA_LAYERS, device=dev)
        params = list(mlp.parameters())
        sizes = mlp_kernel.sizes_of(params)

        x_new, x_e, v = admm_kernel.admm_iter_pre_plain(z, lam, g, t,
                                                        inv_mu_t)
        rows = v.reshape(-1, Dc)
        target = project_parity_polytope(v)
        trows = target.reshape(-1, Dc)

        def pre_k():
            return admm_step.admm_iter_pre_cuda(z, lam, g, st, inv_mu)

        def post_p():
            return admm_kernel.admm_iter_post_plain(
                x0, z, lam, x_new, x_e, target, upd0, done0, t,
                torch.tensor(3.0, device=dev), torch.tensor(thresh,
                                                            device=dev))

        post_state = [a.clone() for a in (x0, z, lam, upd0, done0)]

        def post_k():
            s = post_state
            return admm_step.admm_iter_post_cuda(
                s[0], s[1], s[2], x_new, None, target, s[3], s[4], st, 3.0,
                thresh)

        def fwd_p():
            with torch.no_grad():
                return mlp_kernel.mlp_forward_plain(params, rows)

        err = {}
        xk, vk = pre_k()
        err["admm_iter_pre"] = max(float((xk - x_new).abs().max()),
                                   float((vk - v).abs().max()))
        err["project_rows"] = float(
            (admm_step.project_rows_cuda(v) - target).abs().max())
        err["admm_iter_post"] = max(float((a.float() - b.float()).abs().max())
                                    for a, b in zip(post_k(), post_p()))
        for k in ("admm_iter_pre", "project_rows", "admm_iter_post"):
            if err[k]:
                fail(f"{k} kernel != plain on (a)'s first iteration "
                     f"(max |diff| {err[k]})")
        out_k = mlp_kernel.mlp_forward_cuda(params, rows)
        err["mlp_forward"] = float((out_k - fwd_p()).abs().max())
        loss_k, grads_k = mlp_kernel.mlp_train_cuda(params, rows, trows)
        loss_p, grads_p = mlp_kernel.mlp_train_plain(params, rows, trows)
        rel = [float((a - b).norm() / b.norm())
               for a, b in zip(grads_k, grads_p)]
        rel_loss = abs(float(loss_k) - float(loss_p)) / float(loss_p)
        err["mlp_train"] = max(
            [float((a - b).abs().max()) for a, b in zip(grads_k, grads_p)]
            + [abs(float(loss_k) - float(loss_p))])
        loss2, grads2 = mlp_kernel.mlp_train_cuda(params, rows, trows)
        same = torch.equal(loss_k, loss2) and all(
            torch.equal(a, b) for a, b in zip(grads_k, grads2))
        print(f"check admma kernels on (a)'s first iteration, {rows_b} rows: "
              "admm_iter_pre, project_rows, admm_iter_post bit-equal to "
              f"their plain versions; mlp_forward max |diff| "
              f"{err['mlp_forward']:.3g} (bar 1e-5); mlp_train loss rel "
              f"{rel_loss:.3g}, gradients rel " + ", ".join(
                  f"{r:.3g}" for r in rel) + " (bar 1e-5), max |diff| "
              f"{err['mlp_train']:.3g}; the same bits on a second run: "
              f"{same}", flush=True)
        if not (err["mlp_forward"] <= 1e-5 and rel_loss <= 1e-5
                and max(rel) <= 1e-5 and same):
            fail("the fused MLP kernel is out of its tolerance against the "
                 "plain MLP, or differs between two runs")

        # K3 on (ii): the state after ADMMA_FROZEN_ITERS loop iterations of
        # the exact loop (its plain halves and projection) on (a)'s words,
        # most of them frozen; each timed launch starts from that state.
        mu_t = torch.tensor(3.0, device=dev)
        thresh_t = torch.tensor(thresh, device=dev)
        fz_state = (x0, z, lam, upd0, done0)
        for it in range(ADMMA_FROZEN_ITERS + 1):
            fz_new, fz_e, fz_v = admm_kernel.admm_iter_pre_plain(
                fz_state[1], fz_state[2], g, t, inv_mu_t)
            fz_target = project_parity_polytope(fz_v, mask=t.cmask)
            fz_want = admm_kernel.admm_iter_post_plain(
                *fz_state[:3], fz_new, fz_e, fz_target, *fz_state[3:], t,
                mu_t, thresh_t)
            if it < ADMMA_FROZEN_ITERS:
                fz_state = fz_want[:5]
        fz_work = [a.clone() for a in fz_state]

        def post_frozen():
            for a, b in zip(fz_work, fz_state):
                a.copy_(b)
            torch.cuda._sleep(2_000_000)    # the launch is enqueued meanwhile
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = admm_step.admm_iter_post_cuda(
                *fz_work[:3], fz_new, None, fz_target, *fz_work[3:], st,
                3.0, thresh)
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop), out

        err_fz = max(float((a.float() - b.float()).abs().max())
                     for a, b in zip(post_frozen()[1], fz_want))
        if err_fz:
            fail("admm_iter_post kernel != plain on the frozen-word state "
                 f"(max |diff| {err_fz})")
        ms_fz = min(post_frozen()[0] for _ in range(5))
        running = int((~fz_state[4]).sum())
        fz_bytes = (running * 4 * (5 * C * Dc + 2 * code.get_n())
                    + B_CHECK)
        fz_bound = 1e3 * fz_bytes / HBM_BYTES_PER_S
        print(f"timing admma admm_iter_post on the state after "
              f"{ADMMA_FROZEN_ITERS} loop iterations, B={B_CHECK}: "
              f"{B_CHECK - running} of {B_CHECK} words frozen (share "
              f"{1 - running / B_CHECK:.4f}); bit-equal to plain; kernel "
              f"{ms_fz:.4f} ms; bound {fz_bound:.4f} ms by the running "
              f"words' bytes ({fz_bytes} B) | {card}", flush=True)

        # Times per loop iteration: each kernel beside its plain version,
        # and Adam's update.
        opt = admma.make_adam(mlp, 1e-3)

        def adam_update():
            for p, gr in zip(params, grads_k):
                p.grad = gr
            opt.step()

        timed = {
            "admm_iter_pre": (pre_k, lambda: admm_kernel.admm_iter_pre_plain(
                z, lam, g, t, inv_mu_t)),
            "project_rows": (lambda: admm_step.project_rows_cuda(v),
                             lambda: project_parity_polytope(v)),
            "mlp_forward": (lambda: mlp_kernel.mlp_forward_cuda(params, rows),
                            fwd_p),
            "mlp_train": (
                lambda: mlp_kernel.mlp_train_cuda(params, rows, trows),
                lambda: mlp_kernel.mlp_train_plain(params, rows, trows)),
            "admm_iter_post": (post_k, post_p),
        }
        ms = {}
        for k, (kern, plain) in timed.items():
            ms[k] = (best_ms(kern), best_ms(plain, reps=1))
        ms_adam = best_ms(adam_update)
        # Bounds: bytes in and out once (3.35 TB/s) and operations (67
        # TFLOP/s), for this input.
        plane = 4 * rows_b * Dc
        vec = 4 * B_CHECK * code.get_n()
        clip = v.clamp(0.0, 1.0)
        bracket = int((target != clip).any(dim=-1).sum())
        proj_ops = (rows_b * (Dc * (3 * (Dc - 1) + 7) + 4)
                    + bracket * (2 * Dc * (9 + 5 * Dc) + 6 + 3 * Dc))
        n_par = sum(p.numel() for p in params)
        work = {  # (bytes, operations)
            "admm_iter_pre": (3 * plane + 2 * vec, 5 * rows_b * Dc
                              + 3 * B_CHECK * code.get_n()),
            "project_rows": (2 * plane, proj_ops),
            "admm_iter_post": (5 * plane + 2 * vec, 8 * rows_b * Dc),
            "mlp_forward": (2 * plane + 4 * n_par,
                            mlp_flops(sizes, rows_b, False)),
            "mlp_train": (2 * plane + 8 * n_par,
                          mlp_flops(sizes, rows_b, True)),
        }
        entries = {}
        for k, (nb, nops) in work.items():
            # K4's operations run on the tensor cores, three TF32 products
            # a multiply-add; the FFMA term is printed beside it.
            tc = k.startswith("mlp_")
            ffma = 1e3 * nops / F32_OPS_PER_S
            bound = {"bytes": 1e3 * nb / HBM_BYTES_PER_S,
                     "operations": (1e3 * SPLIT_TF32_PRODUCTS * nops
                                    / TF32_OPS_PER_S) if tc else ffma}
            by = max(bound, key=bound.get)
            entries[k] = {"ms": ms[k][0], "plain_ms": ms[k][1],
                          "bound_ms": bound[by], "bound_by": by,
                          "library_ms": None}
            if k == "admm_iter_post":
                entries[k].update(frozen_ms=ms_fz, frozen_bound_ms=fz_bound,
                                  frozen_share=1 - running / B_CHECK)
            print(f"timing admma {k} at B={B_CHECK} ({rows_b} rows): kernel "
                  f"{ms[k][0]:.4f} ms vs plain {ms[k][1]:.4f}; bound "
                  f"{bound[by]:.4f} ms by {by} (bytes {bound['bytes']:.4f}, "
                  f"operations {bound['operations']:.4f}"
                  + (f" as split TF32 on the tensor cores; as float32 FFMA "
                     f"{ffma:.4f}" if tc else "") + f") | {card}",
                  flush=True)
        per_it = 1e3 * secs / n_loop
        parts = ("admm_iter_pre", "project_rows", "mlp_train",
                 "admm_iter_post")
        print(f"admma ms per loop iteration at B={B_CHECK} (train, kernels): "
              + ", ".join(f"{k} {ms[k][0]:.3f}" for k in parts)
              + f", Adam update {ms_adam:.3f}; their sum "
              f"{sum(ms[k][0] for k in parts) + ms_adam:.3f}, the whole "
              f"iteration {per_it:.3f} (PR 10, plain: 26.317); bracket rows "
              f"{bracket} of {rows_b} | {card}", flush=True)

        # (b) offline training on the card, through K2 and K4.
        t0 = time.perf_counter()
        mlp4, loss4 = admma.train_offline(4, [64, 64], steps=1500, batch=512,
                                          cache_dir=cache, log_every=0,
                                          device=dev)
        secs4 = time.perf_counter() - t0
        xs = torch.as_tensor(np.random.default_rng(0).random(
            (256, 4), dtype=np.float32), device=dev)
        with torch.no_grad():
            mse = float(((mlp4(xs) - project_parity_polytope(xs)) ** 2).mean())
        print(f"admma offline dim 4 [64, 64], 1500 steps of 512: last loss "
              f"{loss4:.6f}, held-out MSE {mse:.6f} (bar 5e-3), "
              f"{1500 / secs4:.1f} steps/s | {card}", flush=True)
        if not mse < 5e-3:
            fail(f"offline training at dim 4 reached MSE {mse} >= 5e-3")
        steps6 = 2000
        with plain_forbidden(), counted(launches, "admma train_offline",
                                        ("project_rows", "mlp_train")):
            t0 = time.perf_counter()
            _, loss6 = admma.train_offline(6, ADMMA_LAYERS, steps=steps6,
                                           batch=1024, cache_dir=cache,
                                           log_every=0, device=dev)
            secs6 = time.perf_counter() - t0
        print(f"admma offline dim 6 {ADMMA_LAYERS}, {steps6} steps of 1024: "
              f"last loss {loss6:.6f}, {steps6 / secs6:.1f} steps/s | {card}",
              flush=True)

        # (c) eval and apprx decodes of the Hamming(7,4) codebook with the
        # dim-4 model, as the CPU tests hold them.
        ham = get_code("7_4_hamming")
        cb = torch.as_tensor(ham.cb, dtype=torch.int32, device=dev)
        g_ham = CHANNELS["bsc"].llr(cb, 0.05)
        for apprx, extra in ((-1, dict(max_iter=100)),
                             (3, dict(max_iter=-1, iter_cap=500))):
            dec = admma.ADMMADecoder(ham.graph, layers=[64, 64], apprx=apprx,
                                     cache_dir=cache, device=dev, **extra)
            with plain_forbidden(), counted(
                    launches, f"admma eval hamming apprx={apprx}",
                    need_eval + (("project_rows",) if apprx > 0 else ())):
                ok = float((dec.decode(g_ham)[0] == cb).all(dim=1)
                           .float().mean())
            print(f"admma eval hamming codebook apprx={apprx}: "
                  f"{ok:.4f} of words decoded", flush=True)
            if (apprx < 0 and ok < 0.75) or (apprx > 0 and ok < 1.0):
                fail(f"ADMMA eval mode (apprx={apprx}) decoded {ok} of the "
                     "Hamming(7,4) codebook")

    # ADMMA eval mode on the flagship with the committed dim-6 model (the
    # MLP serves every iteration): its rate, and its decisions against the
    # plain route's on the same input.
    dec = admma.ADMMADecoder(g_flag, layers=ADMMA_LAYERS,
                             cache_dir=os.path.join(ROOT, "cache"),
                             device=dev, **kw)
    dec.decode(llr[:64])
    with plain_forbidden(), counted(launches, "admma eval decode",
                                    need_eval):
        secs_e, (xe, ie) = events(lambda: dec.decode(llr))
    secs_e /= 1e3
    eval_params = list(dec.mlp.parameters())

    def plain_mlp(it, v_rows):
        with torch.no_grad():
            return mlp_kernel.mlp_forward_plain(
                eval_params, v_rows.reshape(-1, Dc)).reshape(v_rows.shape)

    secs_p, (xp, ip, _) = events(lambda: admm_kernel.admm_decode_plain(
        llr, dec.tables, n_edge=g_flag.n_edge, z_update=plain_mlp, **kw))
    secs_p /= 1e3
    n_diff = int((xp != xe).any(dim=1).sum())
    n_it = int((ip != ie).sum())
    print(f"admma eval {FLAG} biawgn 2.5 dB cap {ADMMA_CAP}, committed "
          f"model: kernels {secs_e:.3f} s = {B_CHECK / secs_e:.1f} cw/s "
          f"(PR 14: 34,685.5), "
          f"plain route {secs_p:.3f} s = {B_CHECK / secs_p:.1f} cw/s; words "
          f"whose decisions differ {n_diff} of {B_CHECK} (bar: at most "
          f"{B_CHECK // 1000}), iteration counts differ on {n_it}; mean "
          f"iterations {float(ie.float().mean()):.3f}, wer "
          f"{float((xe != 1).any(dim=1).float().mean()):.5f} | {card}",
          flush=True)
    if n_diff > B_CHECK // 1000:
        fail(f"ADMMA eval on the kernels differs from the plain route on "
             f"{n_diff} of {B_CHECK} words")

    # (d) the CLI end to end: ADMMA --train and ADMM at the same seed,
    # points and cap. Both run the runner's one pipeline rule and the same
    # generator draws, and train mode decodes as the kernel does, so every
    # tally of the Saver files must agree. The ADMMA runs (train, and eval
    # with the committed model) go through ADMMA's kernels alone.
    saved, n_admm = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        for dec_name in ("ADMMA", "ADMM", "ADMMA eval"):
            argv = ["biawgn", FLAG, dec_name.split()[0], "--codeword", "1",
                    "--max-iter", str(ADMMA_CAP), "--min-wec", "200",
                    "--params", "2.75", "3.0", "--seed", "5", "--console",
                    "--data_dir", os.path.join(tmp, dec_name)]
            if dec_name == "ADMMA eval":
                argv += ["--cache_dir", os.path.join(ROOT, "cache"),
                         "--max-words", str(4 * 4096)]
            else:
                argv += ["--cache_dir", os.path.join(tmp, "cache")]
            if dec_name == "ADMMA":
                argv.append("--train")
            admm_kernel.admm_decode_cuda.launches = 0
            ctx = (contextlib.nullcontext() if dec_name == "ADMM" else
                   plain_forbidden())
            need = (need_train if dec_name == "ADMMA" else
                    need_eval if dec_name == "ADMMA eval" else ())
            with ctx, counted(launches, f"cli {dec_name}", need):
                t0 = time.perf_counter()
                res = cli.main(argv)
                secs = time.perf_counter() - t0
            n = admm_kernel.admm_decode_cuda.launches
            if dec_name == "ADMM":
                n_admm = n
            elif n:
                fail(f"the {dec_name} CLI run launched the ADMM kernel")
            print(f"cli {' '.join(argv[:3])} --max-iter {ADMMA_CAP}"
                  f"{' --train' if dec_name == 'ADMMA' else ''}: {secs:.3f} s, "
                  f"admm_decode launches={n}, " + "; ".join(
                      f"{p}: wec {r['wec']} / tot {r['tot']}, bec {r['bec']}, "
                      f"{r['words_per_sec']:.1f} cw/s" for p, r in res.items())
                  + f" | {card}", flush=True)
            if dec_name == "ADMMA eval":
                if not all(0 < r["tot"] and 0 <= r["wer"] <= 1
                           for r in res.values()):
                    fail("the ADMMA eval CLI run gave no tallies")
                continue
            name = (f"biawgn-{FLAG}-{dec_name}-1-200-3.0-1e-05-{ADMMA_CAP}-"
                    "False" + ("-[100, 100]" if dec_name == "ADMMA" else "")
                    + ".json")
            with open(os.path.join(tmp, dec_name, name)) as fp:
                saved[dec_name] = json.load(fp)
    for key in ("tot", "wec", "wer", "bec", "ber", "dec"):
        if saved["ADMMA"][key] != saved["ADMM"][key]:
            fail(f"ADMMA --train and ADMM CLI Saver files differ in {key}")
    if n_admm < 1:
        fail("the ADMM CLI run did not launch admm_decode")
    print("cli ADMMA --train == ADMM: tot, wec, wer, bec, ber and the "
          "iteration histograms equal at both points", flush=True)
    plot_checks()
    for k, e in entries.items():
        e["max_abs_err"] = err[k]
    return n_admm, launches, entries


def lt_cli_rank(argv) -> dict:
    """Phase 8 (f) in each rank: the luby CLI (``jobs.cli``) with this
    rank's device time in ``busy_s``: CUDA events around each batch's
    ``simulate`` (copies, edge layout, peel), summed, as phase 6 times one
    process."""
    import torch

    from ldpc_decoders_tpu_torch.fountain import lt
    from ldpc_decoders_tpu_torch.parallel import jobs

    real = lt.LTSimulator.simulate
    events = []

    def simulate(self, tables):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(self, tables)
        stop.record()
        events.append((start, stop))
        return out

    lt.LTSimulator.simulate = simulate
    try:
        out = jobs.cli("ldpc_decoders_tpu_torch.fountain.lt:main", argv)
    finally:
        lt.LTSimulator.simulate = real
    torch.cuda.synchronize()
    out["busy_s"] = sum(a.elapsed_time(b) for a, b in events) / 1e3
    return out


def mesh_phase(card: str, lt_one: dict) -> dict:
    """Phase 8, several ranks (``parallel/``), one process per rank. Ranks
    share the card over gloo where it has no card for each. Returns each
    kernel's launches in the ranks' main-path runs."""
    import dataclasses

    import numpy as np
    import torch

    from ldpc_decoders_tpu_torch import campaign
    from ldpc_decoders_tpu_torch.decoders.admma import mlp_init
    from ldpc_decoders_tpu_torch.decoders.bp import BPDecoder
    from ldpc_decoders_tpu_torch.codes import get_code
    from ldpc_decoders_tpu_torch.harness import (
        CapSweepRunner,
        MonteCarloRunner,
        RunConfig,
    )
    from ldpc_decoders_tpu_torch.harness.runner import point_generator
    from ldpc_decoders_tpu_torch.parallel import jobs, spawn

    t_phase = time.perf_counter()
    n = MESH_RANKS
    common = dict(device="cuda", log_freq=1e9)
    flag = RunConfig("biawgn", FLAG, "MSA", MESH_FLAG_PARAMS, codeword=1,
                     min_wec=MESH_FLAG_MIN_WEC, batch=B_STEP,
                     msg_dtype="bfloat16", **common)
    rate = dataclasses.replace(flag, params=[3.0], min_wec=10 ** 9,
                               max_words=MESH_RATE_WORDS)
    admm = RunConfig("biawgn", FLAG, "ADMM", [2.5], codeword=1, min_wec=2000,
                     max_iter=50, batch=B_STEP, **common)
    members = campaign.ENSEMBLE_MEMBERS["REG_ENS"][:2]
    rot = RunConfig("biawgn", "REG_ENS", "SPA", [2.0], codeword=0,
                    min_wec=MESH_ENS_MIN_WEC, batch=B_STEP,
                    msg_dtype="bfloat16", **common)
    joint = dataclasses.replace(rot, batch=B_JOINT, min_wec=1000)
    caps = dataclasses.replace(rate, params=[2.0], max_words=MESH_CAPS_WORDS)
    # (code, channel, param, codeword, variant, decoder keywords)
    edge = [(c, ch, p, cw, v, dict(kw, max_iter=10, check_init=False))
            for c, ch, p, cw in ((FLAG, "biawgn", 2.0, 0),
                                 ("margulis", "biawgn", 2.0, 0))
            for v, kw in (("MSA", {}), ("SPA", {"inf_policy": "saturate"}),
                          ("SPA", {"inf_policy": "reference"}))]
    code_1d = RunConfig("biawgn", "margulis", "MSA", [2.0], codeword=1,
                        min_wec=100, batch=MESH_EDGE_B, **common)
    code_2d = RunConfig("bsc", FLAG, "MSA", [0.035], codeword=1, min_wec=200,
                        batch=MESH_EDGE_B, **common)
    lt_argv = [str(LT_K), str(LT_N), "0.03", str(LT_DELTA), str(LT_CLI_SIMS),
               "--batch", str(LT_BATCH), "--mesh", str(n), "--console"]

    def replay(cfg, seed, idx, param, chunks, cap_labels=None):
        """Sum over the ranks r of ``chunks`` chunks of rank r's stream,
        decoded in this process alone at batch / n (by the cap sweep over
        ``cap_labels`` where given: a column per label, in their order)."""
        one = dataclasses.replace(cfg, batch=cfg.batch // n, seed=seed,
                                  data_dir=None)
        runner = (CapSweepRunner(one, cap_labels) if cap_labels
                  else MonteCarloRunner(one))
        acc = 0
        for r in range(n):
            gen = point_generator(runner.device, seed, idx, r, n)
            for _ in range(chunks):
                host, event = runner._dispatch(param, gen)
                event.synchronize()
                acc = acc + host.numpy().astype(np.int64)
        return acc[:, np.argsort(runner.order)] if cap_labels else acc

    def hold(label, st, want):
        got = [st["wec"], st["bec"]] + (st["dec"]["iter"] if "dec" in st
                                        else [])
        if got != want.tolist():
            fail(f"mesh {label}: the ranks' summed tallies != the replays "
                 f"of each rank's stream")

    def strip(r):
        """Results without the ranks' own clocks."""
        if isinstance(r, dict):
            return {k: strip(v) for k, v in r.items()
                    if k != "words_per_sec"}
        return r

    def wer_close(label, a, b):
        se = math.sqrt(a["wer"] / a["tot"] + b["wer"] / b["tot"])
        z = (a["wer"] - b["wer"]) / se if se else 0.0
        print(f"mesh {label}: wer {a['wer']:.6f} ({a['wec']}/{a['tot']}) vs "
              f"one rank {b['wer']:.6f} ({b['wec']}/{b['tot']}): "
              f"{z:.3f} SE", flush=True)
        if not abs(a["wer"] - b["wer"]) < 6 * se + 1e-9:
            fail(f"mesh {label}: WER more than 6 SE from one rank")

    def one_rank_rate():
        return MonteCarloRunner(rate).run()[3.0]["words_per_sec"]

    launches = {}

    def count(outs, kname, label):
        """Each rank launched ``kname`` and holds the same results."""
        for o in outs:
            if o["launches"][kname] < 1:
                fail(f"mesh {label}: rank {o['rank']} did not launch {kname}")
            if strip(o.get("results")) != strip(outs[0].get("results")):
                fail(f"mesh {label}: the ranks' results differ")
            launches[kname] = launches.get(kname, 0) + o["launches"][kname]

    with tempfile.TemporaryDirectory() as tmp:
        admma_cfg = RunConfig("biawgn", FLAG, "ADMMA", [2.5], codeword=1,
                              min_wec=100, max_iter=ADMMA_CAP, batch=4096,
                              train=True, layers=ADMMA_LAYERS,
                              cache_dir=os.path.join(tmp, "cache"), **common)
        lt_dir = os.path.join(tmp, "lt")
        named = [("flag", ("harness", dict(cfg=flag))),
                 *[(f"rate{i}", ("harness", dict(cfg=rate)))
                   for i in range(2)],
                 ("admm", ("harness", dict(cfg=admm))),
                 ("caps", ("harness", dict(cfg=caps, kind="caps",
                                           caps=CAP_LABELS))),
                 ("rotating", ("harness", dict(cfg=rot, kind="rotating",
                                               members=members))),
                 ("joint", ("harness", dict(cfg=joint, kind="joint",
                                            members=members))),
                 *[(f"edge{i}", ("edge_decode", dict(
                     code=c, variant=v, device="cuda", llr=dict(
                         channel=ch, param=p, words=MESH_EDGE_B, seed=80 + i,
                         codeword=cw), **kw)))
                   for i, (c, ch, p, cw, v, kw) in enumerate(edge)],
                 ("code_1d", ("harness", dict(cfg=code_1d, n_code=n))),
                 ("admma", ("harness", dict(cfg=admma_cfg))),
                 ("luby", (lt_cli_rank,
                           dict(argv=lt_argv + ["--data_dir", lt_dir]))),
                 ("luby_replay", ("lt_replay", dict(
                     k=LT_K, n=LT_N, c=0.03, delta=LT_DELTA,
                     count=LT_CLI_SIMS // n, batch=LT_BATCH // n,
                     device="cuda")))]
        tasks = [t for _, t in named]
        rate_one = [one_rank_rate()]
        t0 = time.perf_counter()
        outs = spawn("ldpc_decoders_tpu_torch.parallel.jobs:sequence", n,
                     args=(tasks,), device="cuda", backend="gloo")
        spawn_s = time.perf_counter() - t0
        rate_one.append(one_rank_rate())
        res = {k: [o[i] for o in outs] for i, (k, _) in enumerate(named)}
        for k, ranks in res.items():
            for o in ranks:
                if k != "luby_replay" and o["jax"]:
                    fail(f"mesh task {k}: rank {o['rank']} imported jax")
        with open(os.path.join(lt_dir, f"luby-{LT_K}-{LT_N}-0.03-"
                               f"{LT_DELTA}.json")) as fp:
            lt_saved = json.load(fp)
        lt_files = os.listdir(lt_dir)

    # (a) the flagship: summed tallies == the replays, chunk for chunk.
    a = res["flag"]
    count(a, "msa_decode", "flagship")
    for idx, p in enumerate(flag.params):
        st = a[0]["results"][p]
        chunks = st["tot"] // flag.batch
        hold(f"flagship {p} dB", st, replay(flag, flag.seed, idx, p, chunks))
        print(f"mesh flagship {p} dB, {n} ranks x {flag.batch // n} words: "
              f"{chunks} chunks, wec {st['wec']} bec {st['bec']} == the sum "
              f"of the ranks' single-process replays | {card}", flush=True)
    cards = min(n, torch.cuda.device_count())
    rates = []
    for i in range(2):
        count(res[f"rate{i}"], "msa_decode", "flagship rate")
        rates.append(res[f"rate{i}"][0]["results"][3.0]["words_per_sec"])
    print(f"timing mesh flagship step MSA bf16 3.0 dB, B={B_STEP}, "
          f"{MESH_RATE_WORDS} words: one rank {rate_one[0]:.1f} / "
          f"{rate_one[1]:.1f} cw/s; {n} ranks over gloo on {cards} card(s), "
          f"tally summed on the host {rates[0]:.1f} / {rates[1]:.1f} cw/s "
          f"| {card}", flush=True)

    # (b) ADMM with its histogram.
    b = res["admm"]
    count(b, "admm_decode", "admm")
    st = b[0]["results"][2.5]
    hold("admm 2.5 dB", st, replay(admm, admm.seed, 0, 2.5,
                                   st["tot"] // admm.batch))
    print(f"mesh admm 2.5 dB cap 50: {st['tot'] // admm.batch} chunks, wec "
          f"{st['wec']}, 2000-bin histogram == the replays' | {card}",
          flush=True)

    # (c) REG_ENS through both routes, member m seeded seed + m.
    for label, cfg in (("rotating", rot), ("joint", joint)):
        count(res[label], "spa_ref_decode", f"REG_ENS {label}")
        for m, name in enumerate(members):
            st = res[label][0]["results"][name][2.0]
            member = dataclasses.replace(cfg, code=name)
            hold(f"REG_ENS {label} {name}", st,
                 replay(member, cfg.seed + m, 0, 2.0, st["tot"] // cfg.batch))
            print(f"mesh REG_ENS {label} {name}: tot {st['tot']} wec "
                  f"{st['wec']} == the replays | {card}", flush=True)

    # (d) edge sharding: against BPDecoder's kernel on the same LLRs.
    for j, (c, ch, p, cw, v, kw) in enumerate(edge):
        o = res[f"edge{j}"][0]
        if not np.array_equal(o["x_hat"], res[f"edge{j}"][1]["x_hat"]):
            fail(f"mesh edge {c} {v}: the ranks' decisions differ")
        llr = jobs.make_llr(c, ch, p, MESH_EDGE_B, 80 + j, "cuda", cw)
        dec = BPDecoder(get_code(c).graph, v, device="cuda", **kw)
        dec.decode(llr)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        xr, itr = dec.decode(llr)
        stop.record()
        torch.cuda.synchronize()
        xr, itr = xr.cpu().numpy(), itr.cpu().numpy()
        ok = ~(o["x_hat"] != xr).any(axis=1)
        bad = int((~ok).sum())
        pol = f" {kw['inf_policy']}" if v == "SPA" else ""
        print(f"mesh edge-sharded {c} {v}{pol} {ch} {p}, B={MESH_EDGE_B}, "
              f"{n} ranks: {bad} words differ from BPDecoder f32; decode "
              f"{o['ms']:.3f} ms (plain PyTorch check pass, gloo sums) vs "
              f"the kernel {start.elapsed_time(stop):.3f} ms | {card}",
              flush=True)
        if bad > 1 or (bad == 0 and not np.array_equal(o["iters"], itr)):
            fail(f"mesh edge {c} {v}{pol}: {bad} words differ, or the "
                 "iteration counts do")
    p = code_1d.params[0]
    if strip(res["code_1d"][0]["results"]) != \
            strip(res["code_1d"][1]["results"]):
        fail("mesh code 1-D: the ranks' results differ")
    wer_close(f"code mesh 1x{n} margulis MSA {p} dB",
              res["code_1d"][0]["results"][p],
              MonteCarloRunner(code_1d).run()[p])

    # (e) ADMMA: data-parallel training, on ADMMA's kernels in each rank.
    e = res["admma"]
    for kname in ("admm_iter_pre", "project_rows", "admm_iter_post",
                  "mlp_train"):
        count(e, kname, "admma")
    mlps = [o["mlp"] for o in e]
    start = mlp_init(6, ADMMA_LAYERS, 0).state_dict()
    for k in mlps[0]:
        if not np.array_equal(mlps[0][k], mlps[1][k]):
            fail(f"mesh admma: the ranks' MLPs differ in {k}")
    if all(np.array_equal(mlps[0][k], start[k].numpy()) for k in mlps[0]):
        fail("mesh admma: training did not move the MLP")
    wer_close("admma train 2.5 dB", e[0]["results"][2.5],
              MonteCarloRunner(admma_cfg).run()[2.5])
    print(f"mesh admma train: MLPs equal on both ranks and moved; "
          f"{e[0]['results'][2.5]['words_per_sec']:.1f} cw/s on {n} ranks | "
          f"{card}", flush=True)

    # (f) the luby CLI on two ranks against the ranks' own replays.
    f, reps = res["luby"], res["luby_replay"]
    count(f, "lt_peel", "luby")
    want = [v for j in range(len(reps[0])) for r in range(n)
            for v in reps[r][j]]
    if lt_files != [f"luby-{LT_K}-{LT_N}-0.03-{LT_DELTA}.json"] or \
            lt_saved["arr"] != want:
        fail("mesh luby: arr != the rank-ordered replays of each rank's "
             "stream")
    ours = np.array(lt_saved["arr"], float)
    with open(os.path.join(ARTIFACTS, f"luby-{LT_K}-{LT_N}-0.03-"
                           f"{LT_DELTA}.json")) as fp:
        ref = np.array(json.load(fp)["arr"], float)
    z_m = (ours.mean() - ref.mean()) / math.sqrt(
        ref.var() / ref.size + ours.var() / ours.size)
    z_s = (ours.std() - ref.std()) / math.sqrt(
        kurtosis_var_of_std(ref) + kurtosis_var_of_std(ours))
    wall = f[0]["seconds"]
    busy = sum(o["busy_s"] for o in f)
    print(f"timing mesh luby c=0.03, {LT_CLI_SIMS} sims, --batch {LT_BATCH}:"
          f" one rank {lt_one['cli_s_per_sim']:.4f} s/sim (device idle "
          f"{lt_one['cli_idle']:.4f}; phase 6), {n} ranks "
          f"{wall / LT_CLI_SIMS:.4f} s/sim (device idle {1 - busy / wall:.4f}"
          f"); mean {ours.mean():.1f} std {ours.std():.1f}: z {z_m:.3f} / "
          f"{z_s:.3f} | {card}", flush=True)
    if not (abs(z_m) < 4 and abs(z_s) < 4):
        fail("mesh luby: mean or std more than 4 SE from the artifact")

    # 2 x 2 batch x code mesh: four ranks.
    outs4 = spawn(jobs.harness, 4, args=(code_2d, "plain", None, 2),
                  device="cuda", backend="gloo")
    p = code_2d.params[0]
    if any(strip(o["results"]) != strip(outs4[0]["results"]) for o in outs4):
        fail("mesh code 2x2: the ranks' results differ")
    wer_close("code mesh 2x2 flagship MSA bsc", outs4[0]["results"][p],
              MonteCarloRunner(code_2d).run()[p])

    # (g) NCCL, one card per rank: (a) and its timed runs again.
    if torch.cuda.device_count() >= n:
        g = spawn("ldpc_decoders_tpu_torch.parallel.jobs:sequence", n,
                  args=(tasks[:3],), device="cuda")
        count([o[0] for o in g], "msa_decode", "flagship nccl")
        for idx, p in enumerate(flag.params):
            st = g[0][0]["results"][p]
            hold(f"flagship nccl {p} dB", st, replay(
                flag, flag.seed, idx, p, st["tot"] // flag.batch))
        rates = []
        for i in (1, 2):
            count([o[i] for o in g], "msa_decode", "flagship rate nccl")
            rates.append(g[0][i]["results"][3.0]["words_per_sec"])
        print(f"mesh flagship over NCCL, {n} cards: tallies == the replays; "
              f"cw/s with the tally summed on the card {rates[0]:.1f} / "
              f"{rates[1]:.1f} | {card}", flush=True)
    else:
        print(f"mesh NCCL: not run, {torch.cuda.device_count()} card(s) "
              f"for {n} ranks | {card}", flush=True)

    # (h) the cap sweep: every label's summed tallies == the replays.
    h = res["caps"]
    count(h, "msa_decode_caps", "cap sweep")
    p = caps.params[0]
    sweep = h[0]["results"]
    chunks = sweep[CAP_LABELS[0]][p]["tot"] // caps.batch
    want = replay(caps, caps.seed, 0, p, chunks, CAP_LABELS)
    t0 = time.perf_counter()
    CapSweepRunner(caps, CAP_LABELS).run()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    for j, lbl in enumerate(CAP_LABELS):
        st = sweep[lbl][p]
        if [st["wec"], st["bec"]] != [int(want[0][j]), int(want[1][j])]:
            fail(f"mesh cap sweep label {lbl}: the ranks' summed tallies != "
                 "the replays of each rank's stream")
    print(f"mesh cap sweep biawgn MSA bf16 {p} dB, labels {CAP_LABELS}, "
          f"{caps.max_words} words, {n} ranks over gloo on {cards} card(s): "
          f"{h[0]['seconds']:.3f} s (one rank {one_s:.3f} s), {chunks} "
          f"chunks, every label's tallies == the replays; wec at the largest "
          f"cap {sweep[max(CAP_LABELS)][p]['wec']} | {card}", flush=True)
    print(f"phase 8 (several ranks): {time.perf_counter() - t_phase:.1f} s, "
          f"the {n}-rank spawn {spawn_s:.1f} s | {card}", flush=True)
    return launches


def plot_checks() -> None:
    """Phase 7 (e), the plots: ``viz.cases HMG`` from the artifacts, and the
    polytope demos with their projections on the card. Where matplotlib is
    not installed, every HMG figure's curves go through the same selection,
    labels and plot functions into a recorder, and nothing is drawn."""
    import importlib.util

    import numpy as np
    import torch

    from ldpc_decoders_tpu_torch.ops.projection import (
        project_parity_polytope,
    )
    from ldpc_decoders_tpu_torch.viz import cases as viz_cases
    from ldpc_decoders_tpu_torch.viz import graph as viz_graph
    from ldpc_decoders_tpu_torch.viz import polytope

    for dim in (2, 3):
        v, z = polytope.demo_points(dim, 500, seed=dim, device="cuda")
        want = project_parity_polytope(torch.as_tensor(v)).numpy()
        err = float(np.abs(z - want).max())
        print(f"polytope demo d={dim}: 500 projections on the card vs the "
              f"CPU, max |diff| {err}", flush=True)
        if not err <= 1e-6:
            fail(f"polytope projections on the card differ from the CPU's by "
                 f"{err}")
    hmg = sorted(f"HMG__{c}{s}.png" for c in ("BEC", "BSC", "BIAWGN")
                 for s in ("", "_WER"))
    with tempfile.TemporaryDirectory() as plots:
        if importlib.util.find_spec("matplotlib") is not None:
            viz_cases.main(["HMG", "--data_dir", ARTIFACTS, "--plots_dir",
                            plots])
            for dim in (2, 3):
                polytope.main([str(dim), "--out", os.path.join(
                    plots, f"polytope_{dim}d.png")])
            made = sorted(os.listdir(plots))
            if made != sorted(hmg + ["polytope_2d.png", "polytope_3d.png"]):
                fail(f"viz.cases HMG and viz.polytope drew {made}")
            print(f"plots: {made} drawn", flush=True)
            return
        # No matplotlib here: every figure's data goes through the same
        # selection, labels and plot functions into a recorder.
        figures = []

        class Recorder(viz_graph.Plotter):
            def __init__(self, args):
                self.args, self.lines = args, []
                figures.append(self)

            def plot_pairs(self, pairs, label, style=None):
                self.lines.append((label, len(pairs)))

            def fmt_err(self):
                pass

            def finish(self, title=None):
                pass

        real = viz_graph.Plotter
        viz_graph.Plotter = Recorder
        try:
            viz_cases.main(["HMG", "--data_dir", ARTIFACTS, "--plots_dir",
                            plots])
        finally:
            viz_graph.Plotter = real
    names = sorted(f"{f.args.file_name}.png" for f in figures)
    decs = {"BEC": 4, "BSC": 5, "BIAWGN": 5}
    for f in figures:
        n_dec = decs[f.args.file_name.split("__")[1].split("_")[0]]
        if len(f.lines) != n_dec or any(n < 9 for _, n in f.lines):
            fail(f"viz.cases HMG figure {f.args.file_name}: {f.lines}")
    if names != hmg:
        fail(f"viz.cases HMG selected {names}")
    print("plots: matplotlib is not installed on this machine, so nothing "
          "was drawn; viz.cases HMG selected its six figures' curves from "
          "the artifacts: " + "; ".join(
              f"{f.args.file_name} " + ", ".join(
                  f"{lb} ({n} points)" for lb, n in f.lines)
              for f in figures), flush=True)


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
    sources = ("msa_decode", "spa_decode", "bec_decode", "admm_decode",
               "lt_peel", "admm_step", "mlp_fused")
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

    # -- 6. LT fountain ------------------------------------------------------
    timed["lt_peel"], launches["lt_peel"] = lt_phase(card)
    knames.append("lt_peel")
    max_err["lt_peel"] = 0      # phase 6 fails on any difference

    # -- 7. ADMMA and the plots ----------------------------------------------
    n_admm, admma_launches, admma_timed = admma_phase(card)
    launches["admm_decode"] += n_admm
    for k, entry in admma_timed.items():
        knames.append(k)
        max_err[k] = entry.pop("max_abs_err")
        timed[k] = entry
        launches[k] = admma_launches.get(k, 0)

    # -- 8. several ranks ------------------------------------------------------
    for kname, n in mesh_phase(card, timed["lt_peel"]["by_c"]["0.03"]).items():
        launches[kname] += n

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
        if k == "lt_peel":      # no Pallas kernel: the JAX sparse engine
            src, replaces = "lt_peel.cu", "ldpc_decoders_tpu/fountain/lt.py:290"
        elif k.startswith("mlp_"):  # no Pallas kernel: the JAX MLP's XLA
            src = "mlp_fused.cu"
            replaces = "ldpc_decoders_tpu/decoders/admma.py:56"
        elif k in ADMMA_KERNELS:    # _admm_core's iteration, split
            src, replaces = "admm_step.cu", pallas + "1219"
        else:
            src, line = sources[k.removesuffix("_caps")]
            replaces = pallas + line
        lines.append({"name": k, "route": "cuda", "source": csrc + src,
                      "replaces": replaces, "launches": launches[k],
                      "max_abs_err": max_err[k], **timed[k]})
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
