"""PyTorch port: edge-sharded BP (``parallel/bp_edge_sharded.py``) against
the JAX package's ``EdgeShardedBPDecoder`` and the port's ``BPDecoder``, on
the CPU over gloo ranks.

- ``build_shard_tables`` equals the JAX function's tables;
- one rank decodes bit for bit as ``BPDecoder``'s plain version in float32
  (MSA, SPA under both inf policies, with and without ``check_init``);
- two ranks, on the same numpy-made LLRs: against ``BPDecoder`` and against
  the JAX decoder on a 2-device CPU ``code`` mesh, the bars of
  tests/test_bp_edge_sharded.py: at most one differing word, and iteration
  counts equal where none differs (on every matching word under the
  reference policy, whose cascade must fire);
- uneven splits: Hamming(7,4)'s 3 checks over 2 ranks, and over 4, where
  one slice is empty;
- the harness on a 1-D code mesh (margulis MSA; LDPC(1200,3,6) refmode
  SPA) and on a 2 x 2 batch x code mesh: WER within 6 SE of one rank;
- ``main --mesh-code 2 --device cpu`` writes one Saver file; the runner
  refuses a code mesh for the erasure and non-BP decoders.
"""

import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from ldpc_decoders_tpu.parallel import bp_edge_sharded as jax_edge  # noqa: E402
from ldpc_decoders_tpu_torch import main as port_main  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.decoders.bp import BPDecoder  # noqa: E402
from ldpc_decoders_tpu_torch.harness import MonteCarloRunner, RunConfig  # noqa: E402
from ldpc_decoders_tpu_torch.parallel import bp_edge_sharded, mesh  # noqa: E402

FLAG = "1200_3_6_ldpc"
HMG = "7_4_hamming"
COMMON = dict(device="cpu", log_freq=1e9)
# name -> (code, variant, decoder kwargs, channel, param, words, seed)
CASES = {
    "msa_awgn": (FLAG, "MSA", dict(check_init=False, max_iter=10),
                 "biawgn", 1.5, 64, 11),
    "spa_awgn": (FLAG, "SPA", dict(check_init=False, max_iter=10),
                 "biawgn", 1.5, 64, 12),
    "spa_sat_awgn": (FLAG, "SPA", dict(check_init=False, max_iter=10,
                                       inf_policy="saturate"),
                     "biawgn", 1.5, 64, 13),
    "spa_ref_bsc": (FLAG, "SPA", dict(max_iter=60), "bsc", 0.05, 64, 14),
    "msa_bsc_conv": (FLAG, "MSA", dict(max_iter=0, iter_cap=30), "bsc",
                     0.04, 64, 15),
    "spa_ref_margulis": ("margulis", "SPA", dict(max_iter=60), "bsc", 0.05,
                         32, 5),
    "hamming_uneven": (HMG, "SPA", dict(check_init=False, max_iter=10),
                       "biawgn", 2.0, 128, 2),
}
JAX_CASES = ["msa_awgn", "spa_awgn", "spa_sat_awgn", "spa_ref_bsc"]
HARNESS_1D = {
    "margulis_msa": RunConfig("biawgn", "margulis", "MSA", [1.5], codeword=1,
                              min_wec=25, batch=128, **COMMON),
    "refmode_spa": RunConfig("bsc", FLAG, "SPA", [0.06], codeword=0,
                             min_wec=15, batch=64, **COMMON),
}
HARNESS_2D = RunConfig("bsc", FLAG, "MSA", [0.035], codeword=1, min_wec=25,
                       batch=128, **COMMON)


def _llr(case):
    """The case's LLRs, made from a numpy seed (codeword 0)."""
    code, _, _, channel, param, words, seed = CASES[case]
    n = get_code(code).get_n()
    rng = np.random.default_rng(seed)
    if channel == "biawgn":
        var = np.float32(10.0 ** (-param / 10.0))
        y = np.float32(-1.0) + np.sqrt(var) * rng.standard_normal(
            (words, n)).astype(np.float32)
        return (-2.0 * y / var).astype(np.float32)
    flips = (rng.random((words, n)) < param).astype(np.float32)
    p = np.float32(param)
    return ((np.log1p(-p) - np.log(p)) * (1.0 - 2.0 * flips)).astype(
        np.float32)


def _edge_task(case):
    code, variant, kw, *_ = CASES[case]
    return ("edge_decode", dict(code=code, variant=variant, llr=_llr(case),
                                **kw))


@pytest.fixture(scope="module")
def two_ranks():
    """Every decode case and the 1-D harness runs in one spawn of two
    ranks: {name: [rank outputs]}."""
    tasks = [_edge_task(c) for c in CASES]
    tasks += [("harness", dict(cfg=cfg, n_code=2))
              for cfg in HARNESS_1D.values()]
    outs = mesh.spawn("ldpc_decoders_tpu_torch.parallel.jobs:sequence", 2,
                      args=(tasks,), device="cpu", num_threads=1)
    names = list(CASES) + list(HARNESS_1D)
    return {name: [o[i] for o in outs] for i, name in enumerate(names)}


@pytest.fixture(scope="module")
def four_ranks():
    """Hamming(7,4) over a 4-rank code mesh (one slice empty) and the 2 x 2
    harness, in one spawn of four ranks."""
    tasks = [_edge_task("hamming_uneven"),
             ("harness", dict(cfg=HARNESS_2D, n_code=2))]
    outs = mesh.spawn("ldpc_decoders_tpu_torch.parallel.jobs:sequence", 4,
                      args=(tasks,), device="cpu", num_threads=1)
    return {"hamming_uneven": [o[0] for o in outs],
            "harness_2d": [o[1] for o in outs]}


def _bp(case):
    code, variant, kw, *_ = CASES[case]
    x, it = BPDecoder(get_code(code).graph, variant, **kw).decode(
        torch.from_numpy(_llr(case)))
    return x.numpy(), it.numpy()


def _hold(xs, its, xr, itr, ref_policy):
    """The bars of tests/test_bp_edge_sharded.py."""
    word_ok = ~(xs != xr).any(axis=1)
    mismatch = int((~word_ok).sum())
    assert mismatch <= 1, f"{mismatch} words differ"
    if mismatch == 0 or ref_policy:
        np.testing.assert_array_equal(its[word_ok], itr[word_ok])
    err_s, err_r = int((xs != 0).sum()), int((xr != 0).sum())
    assert abs(err_s - err_r) <= max(5, 0.05 * max(err_s, err_r))


@pytest.mark.parametrize("code,n_dev", [(HMG, 2), (HMG, 4), (HMG, 8),
                                        (FLAG, 2), (FLAG, 3)])
def test_shard_tables_equal_jax(code, n_dev):
    H = get_code(code).parity_mtx
    ours = bp_edge_sharded.build_shard_tables(H, n_dev)
    theirs = jax_edge.build_shard_tables(H, n_dev)
    np.testing.assert_array_equal(ours.var_of_slot.numpy(),
                                  np.asarray(theirs.var_of_slot))
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(theirs.mask))
    # Each variable's local slots, in slot order, are exactly its edges.
    V = H.shape[1]
    for d in range(n_dev):
        vos = ours.var_of_slot[d].numpy()
        table = bp_edge_sharded.var_slot_table(vos, V)
        real = table[table < vos.size]
        assert sorted(real.tolist()) == np.nonzero(vos < V)[0].tolist()
        for v in range(V):
            row = table[v][table[v] < vos.size]
            assert (np.diff(row) > 0).all() and (vos[row] == v).all()


@pytest.mark.parametrize("case", list(CASES))
def test_one_rank_equals_bp_decoder_plain(case):
    code, variant, kw, *_ = CASES[case]
    dec = bp_edge_sharded.EdgeShardedBPDecoder(
        get_code(code).parity_mtx, mesh.code_mesh(1), variant, **kw)
    x, it = dec.decode(torch.from_numpy(_llr(case)))
    xr, itr = _bp(case)
    np.testing.assert_array_equal(x.numpy(), xr)
    np.testing.assert_array_equal(it.numpy(), itr)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_bp_decoder(two_ranks, case):
    a, b = two_ranks[case]
    np.testing.assert_array_equal(a["x_hat"], b["x_hat"])
    np.testing.assert_array_equal(a["iters"], b["iters"])
    assert not a["jax"] and not b["jax"]
    xr, itr = _bp(case)
    ref = CASES[case][1] == "SPA" and \
        CASES[case][2].get("inf_policy", "reference") == "reference"
    _hold(a["x_hat"], a["iters"], xr, itr, ref)
    if case.startswith("spa_ref"):
        assert (a["iters"] > 1).any()


@pytest.mark.parametrize("case", JAX_CASES)
def test_two_ranks_match_jax_edge_sharded(two_ranks, case):
    code, variant, kw, *_ = CASES[case]
    jm = JaxMesh(np.array(jax.devices()[:2]), ("code",))
    jdec = jax_edge.EdgeShardedBPDecoder(get_code(code).parity_mtx, jm,
                                         variant, **kw)
    xj, itj = jdec.decode(jnp.asarray(_llr(case)))
    a = two_ranks[case][0]
    _hold(a["x_hat"], a["iters"], np.asarray(xj), np.asarray(itj),
          variant == "SPA" and kw.get("inf_policy", "reference")
          == "reference")


def test_four_ranks_with_an_empty_slice(four_ranks):
    outs = four_ranks["hamming_uneven"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["x_hat"], outs[0]["x_hat"])
    xr, itr = _bp("hamming_uneven")
    _hold(outs[0]["x_hat"], outs[0]["iters"], xr, itr, True)
    mask = bp_edge_sharded.build_shard_tables(
        get_code(HMG).parity_mtx, 4).mask
    assert not mask[3].any()


def _wer_close(res_sh, res_one):
    se = math.sqrt(res_sh["wer"] / res_sh["tot"]
                   + res_one["wer"] / res_one["tot"])
    assert abs(res_sh["wer"] - res_one["wer"]) < 6 * se + 1e-9


@pytest.mark.parametrize("name", list(HARNESS_1D))
def test_harness_code_mesh_end_to_end(two_ranks, name):
    cfg = HARNESS_1D[name]
    p = cfg.params[0]
    outs = two_ranks[name]
    assert outs[0]["results"][p]["wec"] == outs[1]["results"][p]["wec"]
    res_sh = outs[0]["results"][p]
    assert res_sh["tot"] >= cfg.batch and res_sh["wec"] >= cfg.min_wec
    _wer_close(res_sh, MonteCarloRunner(cfg).run()[p])


def test_harness_code_mesh_2d(four_ranks):
    outs = four_ranks["harness_2d"]
    p = HARNESS_2D.params[0]
    res = [o["results"][p] for o in outs]
    assert all((r["tot"], r["wec"]) == (res[0]["tot"], res[0]["wec"])
               for r in res)
    assert res[0]["tot"] % HARNESS_2D.batch == 0
    _wer_close(res[0], MonteCarloRunner(HARNESS_2D).run()[p])


def test_cli_mesh_code_writes_one_file(tmp_path):
    res = port_main.main([
        "biawgn", HMG, "MSA", "--params", "2.0", "--codeword", "1",
        "--min-wec", "20", "--batch", "256", "--mesh-code", "2", "--device",
        "cpu", "--console", "--data_dir", str(tmp_path)])
    assert os.listdir(tmp_path) == ["biawgn-7_4_hamming-MSA-1-20-10.json"]
    assert res[2.0]["wec"] >= 20 and res[2.0]["tot"] % 256 == 0


@pytest.mark.parametrize("channel,decoder", [("bec", "SPA"),
                                             ("bsc", "ADMM"),
                                             ("biawgn", "LP")])
def test_runner_refuses_code_mesh(channel, decoder):
    cfg = RunConfig(channel, HMG, decoder, [0.1], **COMMON)
    with pytest.raises(ValueError, match="code-axis sharding"):
        MonteCarloRunner(cfg, mesh=mesh.code_mesh(1))
    one = dataclasses.replace(cfg, channel="bsc", decoder="MSA")
    assert MonteCarloRunner(one, mesh=mesh.code_mesh(1)).code_sharded
