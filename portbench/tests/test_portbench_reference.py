"""The plain reference is the program's arithmetic, written apart from it:
equal to the port's plain route (its kernels' bit-for-bit twin) in
decisions, iteration counts and tallies, and importing nothing of the
program or of JAX."""

import ast
import glob
import os

import numpy as np
import pytest
import torch

from ldpc_decoders_tpu_torch.codes import get_code
from ldpc_decoders_tpu_torch.harness.runner import (
    MonteCarloRunner,
    RunConfig,
    point_generator,
)
from ldpc_decoders_tpu_torch.ops import chunk_kernel
from ldpc_decoders_tpu_torch.ops.admm_kernel import admm_decode_plain
from ldpc_decoders_tpu_torch.ops.graph import bp_tables
from ldpc_decoders_tpu_torch.ops.msa_kernel import msa_decode_plain
from portbench import spec
from portbench.reference import admm, channels, codes, minsum, replay, seeding

FORBIDDEN = {"jax", "jaxlib", "flax", "ldpc_decoders_tpu",
             "ldpc_decoders_tpu_torch"}


def ref_tables(name):
    return codes.tables(codes.load_parity(codes.code_path(spec.ROOT, name)),
                        "cpu")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    spec.HERE, "reference", "**", "*.py"), recursive=True)),
    ids=lambda p: os.path.relpath(p, os.path.join(spec.HERE, "reference")))
def test_reference_imports_nothing_of_the_program(path):
    with open(path) as fp:
        tree = ast.parse(fp.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("name", ["1200_3_6_ldpc", "margulis",
                                  "1200_rho_x5_rand_ldpc_3", "7_4_hamming"])
def test_tables_equal_the_programs(name):
    if name == "7_4_hamming":
        H = get_code(name).parity_mtx
        mine = codes.tables(H, "cpu")
    else:
        mine = ref_tables(name)
    theirs = bp_tables(get_code(name).graph)
    for f in ("chk_var", "cmask", "var_slot", "vmask"):
        assert torch.equal(getattr(mine, f), getattr(theirs, f)), f


@pytest.mark.parametrize("channel,param", [("biawgn", 2.0), ("bsc", 0.06)])
def test_seeding_and_channel_equal_the_programs(channel, param):
    seed, idx = 2 ** 33 + 17, 5
    gen_p = point_generator("cpu", seed, idx)
    gen_r = seeding.point_generator("cpu", seed, idx)
    noise = channels.draw(channel, (8, 100), gen_r, "cpu")
    mod = __import__(f"ldpc_decoders_tpu_torch.channels.{channel}",
                     fromlist=["draw"])
    assert torch.equal(noise, mod.draw((8, 100), gen_p, "cpu"))
    want = chunk_kernel.transmit_plain(channel, noise, param, 1)
    assert torch.equal(channels.llr(channel, 1, noise, param), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_minsum_equals_the_programs_plain_route(dtype):
    t = ref_tables("1200_3_6_ldpc")
    gen = seeding.point_generator("cpu", 3, 0)
    llr = channels.llr("biawgn", 1, channels.draw("biawgn", (48, 1200), gen,
                                                  "cpu"), 1.75)
    x, it = minsum.decode(llr, t, 10, dtype)
    bt = bp_tables(get_code("1200_3_6_ldpc").graph)
    x2, it2 = msa_decode_plain(llr, bt, max_iter=10, check_init=False,
                               msg_dtype=dtype)
    assert torch.equal(x, x2) and torch.equal(it, it2)
    assert 0 < int((x != 1).any(dim=1).sum()) < 48


@pytest.mark.parametrize("code,B,cap", [("margulis", 12, 150),
                                        ("1200_3_6_ldpc", 80, 40)])
def test_admm_equals_the_programs_plain_route(code, B, cap):
    """Both the batch that drops done words and the fixed-size tail (at
    most ``TAIL_WORDS`` running words) hold the plain route's bits."""
    t = ref_tables(code)
    gen = seeding.point_generator("cpu", 4, 1)
    llr = channels.llr("bsc", 1, channels.draw("bsc", (B, t.n_var), gen,
                                               "cpu"), 0.07)
    x, it = admm.decode(llr, t, mu=3.0, eps=1e-5, max_iter=cap)
    bt = bp_tables(get_code(code).graph)
    x2, it2, _ = admm_decode_plain(llr, bt, mu=3.0, eps=1e-5, max_iter=cap,
                                   n_edge=t.n_edge)
    assert torch.equal(x, x2) and torch.equal(it, it2)
    assert len(set(it.tolist())) > 3


@pytest.mark.parametrize("cfg", [
    dict(channel="biawgn", code="1200_3_6_ldpc", decoder="MSA", params=[2.5],
         codeword=1, msg_dtype="bfloat16", batch=32, min_wec=40,
         max_words=4096),
    dict(channel="bsc", code="margulis", decoder="ADMM", params=[0.07],
         codeword=1, max_iter=0, iter_cap=120, batch=16, min_wec=12,
         max_words=4096),
], ids=["msa", "admm"])
def test_replay_equals_the_runners_point(cfg):
    rc = RunConfig(device="cpu", log_freq=1e9, pipeline=4, **cfg)
    seed, idx = 2 ** 32 + 99, 7
    res = MonteCarloRunner(rc).run_param(
        cfg["params"][0], point_generator("cpu", seed, idx))
    t = ref_tables(cfg["code"])
    if cfg["decoder"] == "MSA":
        def dec(llr):
            return minsum.decode(llr, t, 10, torch.bfloat16)
    else:
        def dec(llr):
            return admm.decode(llr, t, mu=3.0, eps=1e-5, max_iter=120)
    ref = replay.replay_point(
        channel=cfg["channel"], codeword=1, param=cfg["params"][0],
        batch=cfg["batch"], n_var=t.n_var,
        gen=seeding.point_generator("cpu", seed, idx), decode=dec,
        min_wec=cfg["min_wec"], max_words=cfg["max_words"], pipeline=4,
        adaptive=True, track_hist=cfg["decoder"] == "ADMM")
    assert (res["tot"], res["wec"], res["bec"]) == (ref["tot"], ref["wec"],
                                                    ref["bec"])
    assert ref["chunks"] > 1
    if "hist" in ref:
        assert np.array_equal(np.asarray(res["dec"]["iter"]), ref["hist"])


@pytest.mark.parametrize("tick,wec,chunks,want", [
    (1, 0, 0, 1), (2, 0, 1, 2), (5, 0, 4, 4), (3, 50, 2, 2), (4, 10, 3, 4),
    (4, 99, 3, 1), (9, 100, 9, 4)])
def test_pipeline_depth_equals_the_runners(tick, wec, chunks, want):
    from ldpc_decoders_tpu_torch.harness.runner import pipeline_depth

    got = replay.pipeline_depth(tick, 4, wec, chunks, 100)
    assert got == want == pipeline_depth(tick, 4, np.array([wec]),
                                         np.array([chunks]), 100)
