"""PyTorch port: the ensemble path against the JAX package.

- ``rand_reg_ldpc`` / ``gen_rand_reg_ldpc`` and the generator CLI: the same
  H and the same files as the JAX functions on the same seeds, bit for bit;
- ``check_member_shapes``: the same errors;
- member rotation: a runner rotated through the members gives each member
  exactly the tallies of a fresh runner seeded as the member is; the
  random-codeword and non-BP refusals;
- ``EnsembleBPDecoder`` (MSA, SPA under both policies) and
  ``EnsembleBECSPADecoder`` on three (48,3,6) members and on
  1200_rho_x5_rand_ldpc_5 (three variables of degree 0, one of degree 1):
  each member's decisions and iteration counts equal its own decoder's bit
  for bit, and the JAX per-member decode on the same numpy-made inputs
  under the bars the port already uses: bf16 MSA and the erasure decoder
  bit-equal (JAX incidence and gather routes), SPA by the statistical bars
  of tests/test_torch_spa.py (bits >= 0.999, word outcomes >= 0.99);
- ``EnsembleMonteCarloRunner``: per-member Saver files with the JAX
  runner's names and keys; at pipeline depth 1 each member's tallies equal
  the rotating route's exactly (each member draws from the generator its
  rotating run uses), and at the default depth within |z| <= 4;
- the campaign's ensemble routes plan and run (tiny sizes, CPU);
- ``ens_average``: tests/test_ens_average.py's cases and byte equality
  with the JAX ``dump_average`` over the committed member files.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ldpc_decoders_tpu.codes import ensembles as jax_ensembles  # noqa: E402
from ldpc_decoders_tpu.codes import get_code as jax_get_code  # noqa: E402
from ldpc_decoders_tpu.codes.code import Code as JaxCode  # noqa: E402
from ldpc_decoders_tpu.decoders import bp as jax_bp  # noqa: E402
from ldpc_decoders_tpu.decoders import bp_ensemble as jax_bp_ensemble  # noqa: E402
from ldpc_decoders_tpu.decoders.bec_spa import BECSPADecoder as JaxBECSPA  # noqa: E402
from ldpc_decoders_tpu.harness import ensemble_runner as jax_ens_runner  # noqa: E402
from ldpc_decoders_tpu.harness import runner as jax_runner  # noqa: E402
from ldpc_decoders_tpu.viz import ens_average as jax_ens_average  # noqa: E402
from ldpc_decoders_tpu_torch import campaign  # noqa: E402
from ldpc_decoders_tpu_torch.codes import ensembles, get_code  # noqa: E402
from ldpc_decoders_tpu_torch.codes.code import save_parity_mtx  # noqa: E402
from ldpc_decoders_tpu_torch.decoders import bp_ensemble  # noqa: E402
from ldpc_decoders_tpu_torch.decoders.bec_spa import BECSPADecoder  # noqa: E402
from ldpc_decoders_tpu_torch.decoders.bp import BPDecoder  # noqa: E402
from ldpc_decoders_tpu_torch.harness import (  # noqa: E402
    MonteCarloRunner,
    RunConfig,
    run_rotating_members,
)
from ldpc_decoders_tpu_torch.harness.ensemble_runner import (  # noqa: E402
    EnsembleMonteCarloRunner,
)
from ldpc_decoders_tpu_torch.ops.graph import TannerGraph  # noqa: E402
from ldpc_decoders_tpu_torch.viz import ens_average  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts", "data")
IREG5 = "1200_rho_x5_rand_ldpc_5"


def _ac_var(w, t):
    """Agresti-Coull adjusted binomial variance of an observed rate."""
    p = (w * t + 2.0) / (t + 4.0)
    return p * (1.0 - p) / (t + 4.0)


def _small_h(count=3, seed=7):
    rng = np.random.default_rng(seed)
    return [ensembles.rand_reg_ldpc(48, 3, 6, rng) for _ in range(count)]


@pytest.fixture
def members(tmp_path, monkeypatch):
    """Three (48,3,6) member files in a code directory of their own."""
    codes = tmp_path / "codes"
    monkeypatch.setenv("FILE_CODES_DIR", str(codes))
    names = []
    for i, H in enumerate(_small_h()):
        names.append(f"ens48_{i + 1}")
        save_parity_mtx(H, names[-1], str(codes))
    return names


# -- generators ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rand_reg_ldpc_equals_jax(seed, tmp_path):
    for n, l, r in ((48, 3, 6), (1200, 3, 6), (60, 2, 4)):
        got = ensembles.rand_reg_ldpc(n, l, r, np.random.default_rng(seed))
        want = jax_ensembles.rand_reg_ldpc(n, l, r,
                                           np.random.default_rng(seed))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    names = ensembles.gen_rand_reg_ldpc(3, 48, 3, 6, seed=seed,
                                        dir_path=str(ours))
    assert names == jax_ensembles.gen_rand_reg_ldpc(
        3, 48, 3, 6, seed=seed, dir_path=str(theirs))
    for name in names:
        assert (ours / f"{name}.txt").read_bytes() == \
            (theirs / f"{name}.txt").read_bytes()
    with pytest.raises(ValueError, match="divisible"):
        ensembles.rand_reg_ldpc(10, 3, 4)


def test_generator_cli_equals_jax(tmp_path, monkeypatch, capsys):
    argv = ["2", "36", "3", "6", "--seed", "4"]
    monkeypatch.setenv("FILE_CODES_DIR", str(tmp_path / "jax"))
    jax_ensembles.main(argv)
    want = capsys.readouterr().out
    monkeypatch.setenv("FILE_CODES_DIR", str(tmp_path / "port"))
    ensembles.main(argv)
    assert capsys.readouterr().out == want
    assert want.splitlines()[0] == "36_3_6_rand_ldpc_1 (18, 36) True True"
    for name in ("36_3_6_rand_ldpc_1", "36_3_6_rand_ldpc_2"):
        assert (tmp_path / "port" / f"{name}.txt").read_bytes() == \
            (tmp_path / "jax" / f"{name}.txt").read_bytes()


def test_check_member_shapes_same_errors():
    hs = _small_h()
    ours = [TannerGraph.from_parity_mtx(h) for h in hs]
    theirs = [JaxCode(None, h).graph for h in hs]
    assert bp_ensemble.check_member_shapes(ours) == \
        jax_bp_ensemble.check_member_shapes(theirs) == (24, 48, 6, 3)
    mixed = (ours[0], get_code("7_4_hamming").graph)
    with pytest.raises(ValueError) as got:
        bp_ensemble.check_member_shapes(mixed)
    with pytest.raises(ValueError) as want:
        jax_bp_ensemble.check_member_shapes(
            (theirs[0], jax_get_code("7_4_hamming").graph))
    assert str(got.value) == str(want.value)
    for cls in (bp_ensemble.EnsembleBPDecoder,
                bp_ensemble.EnsembleBECSPADecoder):
        with pytest.raises(ValueError, match="differ in shape"):
            cls(mixed)
    dec = bp_ensemble.EnsembleBPDecoder(ours, "MSA")
    with pytest.raises(ValueError, match="leading member axis 3"):
        dec.decode(torch.zeros((2, 4, 48)))
    with pytest.raises(ValueError, match="unknown BP variant"):
        bp_ensemble.EnsembleBPDecoder(ours, "ADMM")


# -- member rotation ---------------------------------------------------------

@pytest.mark.parametrize("channel,decoder,codeword", [
    ("bec", "SPA", 0), ("bsc", "MSA", 1), ("biawgn", "MSA", 1),
    ("bsc", "SPA", 0)])
def test_rotation_matches_fresh_runner(members, channel, decoder, codeword):
    cfg = RunConfig(channel, members[0], decoder,
                    params=[1.0 if channel == "biawgn" else 0.1],
                    codeword=codeword, max_iter=5, min_wec=20, batch=64,
                    seed=3, device="cpu", log_freq=1e9)
    rot = MonteCarloRunner(cfg)
    assert rot.rotatable
    rotated = {}
    for i, name in enumerate(members):
        rot.rotate_member(name, seed=cfg.seed + i)
        assert rot.code.parity_mtx.shape == (24, 48)
        assert rot.id_vals[1] == name
        rotated[name] = rot.run()
    via_helper = run_rotating_members(cfg, members)
    for i, name in enumerate(members):
        want = MonteCarloRunner(dataclasses.replace(
            cfg, code=name, seed=cfg.seed + i)).run()
        for res in (rotated[name], via_helper[name]):
            for p, v in want.items():
                assert (res[p]["tot"], res[p]["wec"], res[p]["bec"]) == \
                    (v["tot"], v["wec"], v["bec"]), (name, p)
    # The members do decode differently: rotation swapped the tables.
    assert len({rotated[n][cfg.params[0]]["bec"] for n in members}) > 1


def test_rotation_refusals(members):
    runner = MonteCarloRunner(RunConfig("bsc", "7_4_hamming", "SPA",
                                        params=[0.05], codeword=-1,
                                        min_wec=2, batch=16, device="cpu"))
    with pytest.raises(ValueError, match="codeword"):
        runner.rotate_member("7_4_hamming")
    admm = MonteCarloRunner(RunConfig("bsc", members[0], "ADMM",
                                      params=[0.05], min_wec=2,
                                      device="cpu"))
    assert not admm.rotatable
    with pytest.raises(ValueError, match="rotation"):
        admm.rotate_member(members[1])


# -- ensemble decoders -------------------------------------------------------

def _bars(got, want, bits_bar=0.999, words_bar=0.99):
    bits = float((got == want).mean())
    words = float(((got != 0).any(1) == (want != 0).any(1)).mean())
    assert bits >= bits_bar and words >= words_bar, (bits, words)


def _inputs(channel, G, B, V, seed, param):
    """Numpy-made decoder inputs of the all-zero word, [G, B, V]: f32 LLRs
    (biAWGN, BSC) or symbols {0, 1, 2} (BEC)."""
    rng = np.random.default_rng(seed)
    if channel == "bec":
        return np.where(rng.random((G, B, V)) < param, 2, 0).astype(np.int32)
    if channel == "bsc":
        flips = rng.random((G, B, V)) < param
        return ((1 - 2 * flips.astype(np.float64))
                * np.log((1 - param) / param)).astype(np.float32)
    nv = 10.0 ** (-param / 10.0)
    y = -1.0 + np.sqrt(nv) * rng.standard_normal((G, B, V))
    return (-2.0 * y / nv).astype(np.float32)


# (name, channel, param, variant, policy, msg dtype, JAX route, bit-equal)
_DECODE_CASES = [
    ("msa-bf16", "biawgn", 2.0, "MSA", "saturate", "bfloat16", "incidence",
     True),
    ("spa-ref-f32-bsc", "bsc", 0.05, "SPA", "reference", "float32",
     "incidence", False),
    ("spa-sat-bf16", "biawgn", 2.0, "SPA", "saturate", "bfloat16",
     "incidence", False),
    ("bec", "bec", 0.4, None, None, None, "gather", True),
]


@pytest.mark.parametrize("ens", ["48", "ireg5"])
@pytest.mark.parametrize("case", _DECODE_CASES, ids=lambda c: c[0])
def test_ensemble_decoders_match_members_and_jax(ens, case):
    _, channel, param, variant, policy, dtype, route, exact = case
    if ens == "48":
        hs, B, cap = _small_h(), 128, 20
    else:
        hs, B, cap = [get_code(IREG5).parity_mtx], 128, 100
    graphs = [TannerGraph.from_parity_mtx(h) for h in hs]
    G, V = len(hs), hs[0].shape[1]
    check_init = channel != "biawgn"
    inp = _inputs(channel, G, B, V, seed=G + int(param * 100), param=param)
    if channel == "bec":
        ens_dec = bp_ensemble.EnsembleBECSPADecoder(graphs, max_iter=cap)
        own = [BECSPADecoder(g, max_iter=cap) for g in graphs]
    else:
        ens_dec = bp_ensemble.EnsembleBPDecoder(
            graphs, variant, max_iter=cap, msg_dtype=dtype,
            check_init=check_init, inf_policy=policy)
        own = [BPDecoder(g, variant, max_iter=cap, msg_dtype=dtype,
                         check_init=check_init, inf_policy=policy)
               for g in graphs]
    x_ens, it_ens = ens_dec.decode(torch.from_numpy(inp))
    assert x_ens.shape == (G, B, V) and it_ens.shape == (G, B)
    assert x_ens.dtype == it_ens.dtype == torch.int32
    for g in range(G):
        x_own, it_own = own[g].decode(torch.from_numpy(inp[g]))
        assert torch.equal(x_ens[g], x_own) and torch.equal(it_ens[g], it_own)
        jg = JaxCode(None, hs[g]).graph
        if channel == "bec":
            jdec = JaxBECSPA(jg, max_iter=cap)
        else:
            jdec = jax_bp.BPDecoder(jg, variant, max_iter=cap,
                                    msg_dtype=getattr(jnp, dtype),
                                    check_init=check_init, perm=route,
                                    inf_policy=policy)
        xj, ij = jax.jit(jdec.decode)(jnp.asarray(inp[g]))
        xj, xe = np.asarray(xj), x_ens[g].numpy()
        if exact:
            np.testing.assert_array_equal(xe, xj)
            np.testing.assert_array_equal(it_ens[g].numpy(), np.asarray(ij))
        else:
            _bars(xe, xj)
        wrong = (xe != 0).any(1)
        assert 0 < int(wrong.sum()) < B, (g, int(wrong.sum()))
    if ens == "ireg5":
        # The three empty columns: the marginal is the LLR alone; an erased
        # empty variable stays erased, and its word ends by the stopping-set
        # rule, not at the cap.
        empty = np.nonzero(hs[0].sum(axis=0) == 0)[0]
        assert list(empty) == [24, 432, 584]
        xe, it = x_ens[0].numpy(), it_ens[0].numpy()
        if channel == "bec":
            erased = inp[0][:, empty] == 2
            assert erased.any()
            np.testing.assert_array_equal(xe[:, empty] == 2, erased)
            assert (it[erased.any(1)] < cap).all()
        else:
            np.testing.assert_array_equal(xe[:, empty],
                                          (inp[0][:, empty] < 0))


@pytest.mark.parametrize("name,p,cap", [("1200_3_6_rand_ldpc_7", 0.041, 10),
                                        ("1200_rho_x5_rand_ldpc_4", 0.0751,
                                         100)])
def test_bsc_msa_f32_member_points_follow_jax_on_llr_last_bit(name, p, cap):
    """The two ensemble points of the BSC min-sum f32 legs where the card's
    campaign run fell |z| > 4 from the goldens (REG members at p = 0.041
    cap 10, all ten members shifted up; IREG members at p = 0.0751 cap 100,
    all ten shifted down): there the word error rate hangs on the last bit
    of the LLR magnitude L (every message is a multiple of it). On the same
    LLRs the port decides as the JAX gather route in f32 (the tie-jitter
    bar of tests/test_torch_msa.py: <= 1% of words differ), at the
    correctly rounded L and one ulp above it, and the WER moves between
    the two by more than the goldens' 4-sigma band (~0.02 at 16384
    words)."""
    B = 512
    mag0 = np.float32(np.log((1 - p) / p))
    flips = np.random.default_rng(5).random((B, 1200)) < p
    port = BPDecoder(get_code(name).graph, "MSA", max_iter=cap,
                     msg_dtype="float32", check_init=True)
    ref = jax.jit(jax_bp.BPDecoder(jax_get_code(name).graph, "MSA",
                                   max_iter=cap, msg_dtype=jnp.float32,
                                   perm="gather", check_init=True).decode)
    wers = []
    for mag in (mag0, np.nextafter(mag0, np.float32(np.inf))):
        llr = np.where(flips, mag, -mag).astype(np.float32)   # codeword 1
        x, _ = port.decode(torch.from_numpy(llr))
        xj = np.asarray(ref(jnp.asarray(llr))[0])
        assert int((x.numpy() != xj).any(axis=1).sum()) <= 0.01 * B
        wers.append(float((x.numpy() != 1).any(axis=1).mean()))
    assert abs(wers[0] - wers[1]) >= 0.02, wers


# -- joint runner ------------------------------------------------------------

@pytest.mark.parametrize("channel,decoder,codeword,param", [
    ("biawgn", "MSA", 1, 1.5), ("bec", "SPA", 0, 0.35),
    ("bsc", "SPA", 0, 0.06)])
def test_joint_runner_files_and_rotating_route(members, tmp_path, channel,
                                               decoder, codeword, param):
    common = dict(channel=channel, code="ens48", decoder=decoder,
                  params=[param], codeword=codeword, min_wec=30, batch=64,
                  log_freq=1e9)
    dirs = {k: str(tmp_path / k) for k in ("joint", "rot", "jax", "deep")}
    cfg = RunConfig(device="cpu", pipeline=1, data_dir=dirs["joint"],
                    **common)
    joint = EnsembleMonteCarloRunner(cfg, members).run()
    rot = run_rotating_members(dataclasses.replace(cfg, data_dir=dirs["rot"]),
                               members)
    jax_ens_runner.EnsembleMonteCarloRunner(
        jax_runner.RunConfig(data_dir=dirs["jax"], **common), members).run()
    names = sorted(os.listdir(dirs["jax"]))
    assert names == [f"{channel}-{m}-{decoder}-{codeword}-30-10.json"
                     for m in members]
    assert sorted(os.listdir(dirs["joint"])) == names == \
        sorted(os.listdir(dirs["rot"]))
    for name in names:
        with open(os.path.join(dirs["joint"], name)) as fp:
            ours = json.load(fp)
        with open(os.path.join(dirs["jax"], name)) as fp:
            theirs = json.load(fp)
        assert list(ours) == list(theirs)
        assert [ours[k] for k in list(ours)[:6]] == \
            [theirs[k] for k in list(theirs)[:6]]
        assert list(ours["wer"]) == [str(param)]
    # Depth 1: each member's chunks are its rotating run's, to the word.
    for m in members:
        a, b = joint[m][param], rot[m][param]
        assert (a["tot"], a["wec"], a["bec"]) == (b["tot"], b["wec"], b["bec"])
        assert a["wec"] >= 30
    # Default depth: chunks in flight past a member's stop still count.
    deep = EnsembleMonteCarloRunner(dataclasses.replace(
        cfg, pipeline=4, data_dir=dirs["deep"]), members).run()
    for m in members:
        a, b = deep[m][param], rot[m][param]
        z = (a["wer"] - b["wer"]) / math.sqrt(_ac_var(a["wer"], a["tot"])
                                              + _ac_var(b["wer"], b["tot"]))
        assert abs(z) <= 4.0, (m, a, b)
        assert a["tot"] >= b["tot"] and a["words_per_sec"] > 0


def test_joint_runner_refusals(members):
    cfg = RunConfig("bsc", "ens48", "MSA", params=[0.05], device="cpu")
    from ldpc_decoders_tpu_torch.parallel import code_mesh
    with pytest.raises(ValueError, match="shards the batch only"):
        EnsembleMonteCarloRunner(cfg, members, mesh=code_mesh(1))
    with pytest.raises(ValueError, match="SPA/MSA"):
        EnsembleMonteCarloRunner(dataclasses.replace(cfg, decoder="ADMM"),
                                 members)
    with pytest.raises(ValueError, match="random-codeword"):
        EnsembleMonteCarloRunner(dataclasses.replace(cfg, codeword=-1),
                                 members)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EnsembleMonteCarloRunner(dataclasses.replace(cfg, device="cuda"),
                                     members)


# -- campaign ----------------------------------------------------------------

@pytest.mark.parametrize("joint", [False, True])
def test_campaign_reg_ens_runs_cpu(tmp_path, joint):
    """REG_ENS at a tiny size (one sweep point per leg): 5 legs x 10
    members, one Saver file each with the name of a per-member run."""
    res = campaign.run_campaign(
        ["REG_ENS"], data_dir=str(tmp_path), device="cpu",
        joint_ensemble=joint,
        overrides=dict(batch=8, min_wec=1, max_words=16, params=[0.3],
                       log_freq=1e9))
    assert len(res) == 5
    route = "ensemble:" if joint else "rotating:"
    members = campaign.ENSEMBLE_MEMBERS["REG_ENS"]
    for (case, argv), legs in res.items():
        assert case == "REG_ENS" and argv.startswith(route)
        assert list(legs) == members
        assert all(leg[0.3]["tot"] >= 8 for leg in legs.values())
    names = sorted(p.name for p in tmp_path.iterdir())
    want = sorted(f"{cfg.channel}-{m}-{cfg.decoder}-{cfg.codeword}-1-10.json"
                  for cfg in campaign.def_cases("REG_ENS") for m in members)
    assert names == want


def test_campaign_ensembles_need_the_card_by_default(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["REG_ENS"], ["IREG_ENS", "--joint-ensemble"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            campaign.main(argv)


# -- ensemble averages -------------------------------------------------------

def test_dump_average_schema_and_math(tmp_path):
    for i, wer in [(1, 0.1), (2, 0.3), (10, 0.2)]:
        with open(tmp_path / f"bec-pfx_{i}-SPA-0-100-10.json", "w") as fp:
            json.dump({"wer": {"0.3": wer, "0.4": 2 * wer},
                       "ber": {"0.3": wer / 10}}, fp)
    # A different decoder and a different prefix must not be picked up.
    with open(tmp_path / "bec-pfx_1-MSA-1-100-10.json", "w") as fp:
        json.dump({"wer": {"0.3": 9.0}, "ber": {}}, fp)
    with open(tmp_path / "bec-pfx_extra_1-SPA-0-100-10.json", "w") as fp:
        json.dump({"wer": {"0.3": 9.0}, "ber": {}}, fp)
    assert sorted(ens_average.member_files(str(tmp_path), "bec", "pfx",
                                           "SPA")) == ["pfx_1", "pfx_10",
                                                       "pfx_2"]
    path = ens_average.dump_average(str(tmp_path), "bec", "pfx", "SPA")
    with open(path) as fp:
        d = json.load(fp)
    assert os.path.basename(path) == "bec-pfx-SPA.json"
    assert d["channel"] == "bec" and d["prefix"] == "pfx"
    assert d["sources"] == ["pfx_1", "pfx_10", "pfx_2"]
    assert abs(d["wer"]["0.3"] - 0.2) < 1e-12
    assert abs(d["wer"]["0.4"] - 0.4) < 1e-12
    assert abs(d["ber"]["0.3"] - 0.02) < 1e-12
    with pytest.raises(FileNotFoundError):
        ens_average.dump_average(str(tmp_path), "bsc", "pfx", "SPA")


def test_comp_average_partial_params():
    avg = ens_average.comp_average([{"0.3": 0.1}, {"0.3": 0.3, "0.4": 0.5}])
    assert avg == {"0.3": 0.2, "0.4": 0.5}


_SUMMARIES = [(ch, pfx, dec) for pfx in ("1200_3_6_rand_ldpc",
                                         "1200_rho_x5_rand_ldpc")
              for ch, dec in (("bec", "SPA"), ("bsc", "SPA"), ("bsc", "MSA"),
                              ("biawgn", "SPA"), ("biawgn", "MSA"))]


@pytest.mark.parametrize("channel,prefix,decoder", _SUMMARIES)
def test_ens_average_equals_jax_and_committed(tmp_path, channel, prefix,
                                              decoder):
    """Over the committed member files the port's summary is byte-equal to
    the JAX ``dump_average``'s."""
    assert len(ens_average.member_files(ART, channel, prefix, decoder)) == 10
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = ens_average.dump_average(ART, channel, prefix, decoder,
                                    out_dir=str(tmp_path / "port"))
    theirs = jax_ens_average.dump_average(ART, channel, prefix, decoder,
                                          out_dir=str(tmp_path / "jax"))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_ens_average_cli(tmp_path, capsys):
    ens_average.main(["bsc", "1200_rho_x5_rand_ldpc", "SPA", "MSA",
                      "--data_dir", ART, "--out_dir", str(tmp_path)])
    out = capsys.readouterr().out.split()
    assert [os.path.basename(p) for p in out] == [
        "bsc-1200_rho_x5_rand_ldpc-SPA.json",
        "bsc-1200_rho_x5_rand_ldpc-MSA.json"]
