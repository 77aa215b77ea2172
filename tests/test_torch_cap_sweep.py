"""PyTorch port: iteration-cap snapshots (``decode_multi_cap``, the
kernels' ``caps=`` planes in their plain versions), ``CapSweepRunner`` and
the campaign registry against the JAX package.

- plane k and ``iters[k]`` of ``decode_multi_cap`` equal the port's own
  ``decode`` at ``max_iter=caps[k]`` bit for bit (MSA bf16/f32, SPA both
  policies, the erasure decoder);
- MSA bf16 planes equal ``msa_decode_pallas(interpret=True, caps=...)`` bit
  for bit; erasure planes equal the JAX ``decode_multi_cap`` on the gather
  route and on the Pallas kernel in interpret mode. SPA planes are held to
  the statistical bars of tests/test_torch_spa.py (torch-CPU and XLA-CPU
  libm differ in the last bit);
- ``CapSweepRunner``: the JAX package's label semantics and file names;
  one chunk's ``[2, K]`` tally equals the JAX runner's on the same
  injected channel output;
- ``campaign --emit`` prints the JAX package's lines for every case.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ldpc_decoders_tpu import campaign as jax_campaign  # noqa: E402
from ldpc_decoders_tpu.codes import get_code as jax_get_code  # noqa: E402
from ldpc_decoders_tpu.decoders import bp as jax_bp  # noqa: E402
from ldpc_decoders_tpu.decoders.bec_spa import BECSPADecoder as JaxBECSPA  # noqa: E402
from ldpc_decoders_tpu.harness import cap_sweep as jax_cap_sweep  # noqa: E402
from ldpc_decoders_tpu.harness import runner as jax_runner  # noqa: E402
from ldpc_decoders_tpu.ops.pallas_bp import msa_decode_pallas, slot_tables  # noqa: E402
from ldpc_decoders_tpu_torch import campaign  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.decoders.bec_spa import BECSPADecoder  # noqa: E402
from ldpc_decoders_tpu_torch.decoders.bp import BPDecoder  # noqa: E402
from ldpc_decoders_tpu_torch.harness import CapSweepRunner, RunConfig  # noqa: E402

CAPS = [1, 2, 3, 6, 10, 40, 100]
PCAPS = [1, 2, 3, 6]
FLAG = "1200_3_6_ldpc"


def _bsc_llr(n, B, p, seed, codeword=1):
    flips = np.random.default_rng(seed).random((B, n)) < p
    y = (codeword + flips) % 2
    return ((1 - 2 * y.astype(np.float64))
            * np.log((1 - p) / p)).astype(np.float32)


def _awgn_llr(n, B, snr, seed, codeword=0):
    nv = 10.0 ** (-snr / 10.0)
    y = (2.0 * codeword - 1.0) + np.sqrt(nv) * np.random.default_rng(
        seed).standard_normal((B, n))
    return (-2.0 * y / nv).astype(np.float32)


def _erased(n, B, p, seed):
    return np.where(np.random.default_rng(seed).random((B, n)) < p, 2,
                    1).astype(np.int32)


@pytest.mark.parametrize("variant,policy,msg_dtype", [
    ("MSA", "saturate", "bfloat16"), ("MSA", "saturate", "float32"),
    ("SPA", "reference", "float32"), ("SPA", "saturate", "float32"),
    ("SPA", "reference", "bfloat16"),
])
def test_bp_multi_cap_matches_per_cap(variant, policy, msg_dtype):
    g = get_code("7_4_hamming").graph
    llr = torch.from_numpy(_bsc_llr(7, 512, 0.12, seed=3))
    kw = dict(msg_dtype=msg_dtype, inf_policy=policy)
    x_hats, iters = BPDecoder(g, variant, max_iter=CAPS[-1],
                              **kw).decode_multi_cap(llr, CAPS)
    assert x_hats.shape == (len(CAPS), 512, 7) and x_hats.dtype == torch.int32
    assert iters.shape == (len(CAPS), 512) and iters.dtype == torch.int32
    for k, cap in enumerate(CAPS):
        x_ref, it_ref = BPDecoder(g, variant, max_iter=cap, **kw).decode(llr)
        assert torch.equal(x_hats[k], x_ref), cap
        assert torch.equal(iters[k], it_ref), cap
    assert not torch.equal(x_hats[0], x_hats[-1])


@pytest.mark.parametrize("variant,policy", [("MSA", "saturate"),
                                            ("SPA", "reference")])
def test_bp_multi_cap_flagship_check_init_false(variant, policy):
    """biAWGN semantics (no syndrome test before the first iteration) on
    the flagship; a batch that converges early fills the later planes."""
    g = get_code(FLAG).graph
    llr = torch.from_numpy(_awgn_llr(1200, 24, 3.5, seed=8))
    kw = dict(msg_dtype="bfloat16", inf_policy=policy, check_init=False)
    caps = [1, 3, 10, 40]
    x_hats, iters = BPDecoder(g, variant, max_iter=40,
                              **kw).decode_multi_cap(llr, caps)
    for k, cap in enumerate(caps):
        x_ref, it_ref = BPDecoder(g, variant, max_iter=cap, **kw).decode(llr)
        assert torch.equal(x_hats[k], x_ref) and torch.equal(iters[k], it_ref)
    assert int(iters.max()) < 40 and int(iters.min()) >= 1


@pytest.mark.parametrize("name,p", [("7_4_hamming", 0.4), (FLAG, 0.4),
                                    ("1200_rho_x5_rand_ldpc_3", 0.42)])
def test_bec_multi_cap_matches_per_cap_and_jax(name, p):
    n = get_code(name).get_n()
    y = _erased(n, 64, p, seed=5)
    g = get_code(name).graph
    x_hats, iters = BECSPADecoder(g, max_iter=CAPS[-1]).decode_multi_cap(
        torch.from_numpy(y), CAPS)
    for k, cap in enumerate(CAPS):
        x_ref, it_ref = BECSPADecoder(g, max_iter=cap).decode(
            torch.from_numpy(y))
        assert torch.equal(x_hats[k], x_ref) and torch.equal(iters[k], it_ref)
    xj, ij = JaxBECSPA(jax_get_code(name).graph,
                       max_iter=CAPS[-1]).decode_multi_cap(jnp.asarray(y), CAPS)
    np.testing.assert_array_equal(x_hats.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(ij))


def test_bec_multi_cap_equals_pallas_interpret():
    y = _erased(1200, 32, 0.4, seed=13)
    x_hats, iters = BECSPADecoder(get_code(FLAG).graph,
                                  max_iter=PCAPS[-1]).decode_multi_cap(
        torch.from_numpy(y), PCAPS)
    xj, ij = JaxBECSPA(jax_get_code(FLAG).graph, max_iter=PCAPS[-1],
                       perm="pallas").decode_multi_cap(jnp.asarray(y), PCAPS)
    np.testing.assert_array_equal(x_hats.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(ij))


@pytest.mark.parametrize("snr", [2.0, 3.0])
def test_msa_bf16_planes_equal_pallas_interpret(snr):
    B = 64
    llr = _awgn_llr(1200, B, snr, seed=int(snr * 10))
    dec = BPDecoder(get_code(FLAG).graph, "MSA", max_iter=PCAPS[-1],
                    msg_dtype="bfloat16", check_init=False)
    x_hats, iters = dec.decode_multi_cap(torch.from_numpy(llr), PCAPS)
    a_tab, h_tab = slot_tables(jax_get_code(FLAG).graph)
    xk, ik = msa_decode_pallas(a_tab, h_tab, jnp.asarray(llr),
                               max_iter=PCAPS[-1], check_init=False,
                               interpret=True, caps=tuple(PCAPS))
    np.testing.assert_array_equal(x_hats.numpy(), np.asarray(xk))
    np.testing.assert_array_equal(
        iters.numpy(), np.minimum(np.asarray(ik)[None],
                                  np.asarray(PCAPS)[:, None]))


@pytest.mark.parametrize("policy", ["saturate", "reference"])
def test_spa_planes_vs_jax_statistical(policy):
    """SPA f32 planes against the JAX gather route's ``decode_multi_cap``:
    bits >= 0.999 and word outcomes >= 0.99 per plane."""
    B, caps = 128, [1, 3, 10]
    llr = _bsc_llr(1200, B, 0.05, seed=5, codeword=0)
    x_hats, _ = BPDecoder(get_code(FLAG).graph, "SPA", max_iter=10,
                          inf_policy=policy).decode_multi_cap(
        torch.from_numpy(llr), caps)
    dec = jax_bp.BPDecoder(jax_get_code(FLAG).graph, "SPA", max_iter=10,
                           inf_policy=policy)
    xj, _ = dec.decode_multi_cap(jnp.asarray(llr), caps)
    for got, want in zip(x_hats.numpy(), np.asarray(xj)):
        assert float((got == want).mean()) >= 0.999
        assert float(((got != 0).any(1) == (want != 0).any(1)).mean()) >= 0.99


@pytest.mark.parametrize("ulps,lo,hi", [(0, 0.9, 1.0), (-1, 0.0, 0.4)])
def test_bsc_msa_f32_deep_cap_follows_jax_on_llr_last_bit(ulps, lo, hi):
    """Float32 min-sum on the BSC at a deep cap hangs on the LAST BIT of
    the LLR magnitude (every message is a multiple of it: exact ties). At
    p = 0.0551, cap 100, the correctly rounded log((1-p)/p) leaves almost
    every word stuck and one ulp less decodes most of them. The port must
    follow the JAX gather route on the same LLRs in both regimes: word
    error rates in the same band and within 4/64 of each other."""
    B, p, caps = 64, 0.0551, [10, 100]
    mag = np.float32(np.log((1 - p) / p))
    if ulps:
        mag = np.nextafter(mag, np.float32(0))
    flips = np.random.default_rng(5).random((B, 1200)) < p
    llr = np.where(flips, mag, -mag).astype(np.float32)       # codeword 1
    kw = dict(max_iter=100, check_init=True)
    x_hats, _ = BPDecoder(get_code(FLAG).graph, "MSA", msg_dtype="float32",
                          **kw).decode_multi_cap(torch.from_numpy(llr), caps)
    xj, _ = jax_bp.BPDecoder(jax_get_code(FLAG).graph, "MSA",
                             msg_dtype=jnp.float32, perm="gather",
                             **kw).decode_multi_cap(jnp.asarray(llr), caps)
    wer_port = float((x_hats[-1].numpy() != 1).any(axis=1).mean())
    wer_jax = float((np.asarray(xj)[-1] != 1).any(axis=1).mean())
    assert lo <= wer_port <= hi and lo <= wer_jax <= hi, (wer_port, wer_jax)
    assert abs(wer_port - wer_jax) <= 4 / B


def test_cap_sweep_runner_end_to_end(tmp_path):
    """All caps tallied from one pass; per-cap files named as a per-cap
    MonteCarloRunner would name them; error counts non-increasing in the
    cap (same noise realizations). Label 0 = raw channel output; label -1
    = run to convergence."""
    cfg = RunConfig(channel="bsc", code="7_4_hamming", decoder="MSA",
                    params=[0.08], codeword=1, min_wec=30, batch=256,
                    data_dir=str(tmp_path), log_freq=1e9, iter_cap=500,
                    device="cpu")
    caps = [0, 1, 3, 10, -1]
    res = CapSweepRunner(cfg, caps).run()
    assert set(res.keys()) == set(caps)
    wecs = {c: res[c][0.08]["wec"] for c in caps}
    assert wecs[0] >= wecs[1] >= wecs[3] >= wecs[10] >= wecs[-1]
    tot = res[0][0.08]["tot"]
    assert res[0][0.08]["wec"] >= 0.35 * tot   # 1-(1-.08)^7 ~ 0.44
    for c in caps:
        f = tmp_path / f"bsc-7_4_hamming-MSA-1-30-{c}.json"
        assert f.exists(), list(tmp_path.iterdir())
        assert res[c][0.08]["wec"] >= 30 or res[c][0.08]["tot"] >= 256


def test_cap_sweep_zero_label_biawgn(tmp_path):
    """biAWGN raw-output slot: the golden vintage compared the real-valued
    y to the bits, so WER = BER = 1 exactly."""
    cfg = RunConfig(channel="biawgn", code="7_4_hamming", decoder="SPA",
                    params=[2.0], codeword=1, min_wec=10, batch=128,
                    data_dir=str(tmp_path), log_freq=1e9, device="cpu")
    res = CapSweepRunner(cfg, [0, 10]).run()
    s = res[0][2.0]
    assert s["wer"] == 1.0 and s["ber"] == 1.0
    assert res[10][2.0]["wer"] < 0.5


def test_cap_sweep_refusals():
    kw = dict(channel="bsc", code="7_4_hamming", params=[0.08], device="cpu")
    with pytest.raises(ValueError, match="BP decoders"):
        CapSweepRunner(RunConfig(decoder="ML", **kw), [1, 2])
    cfg = RunConfig(decoder="MSA", iter_cap=50, **kw)
    with pytest.raises(ValueError, match="at most one"):
        CapSweepRunner(cfg, [0, 0, 3])
    with pytest.raises(ValueError, match="duplicate"):
        CapSweepRunner(cfg, [50, -1])
    with pytest.raises(ValueError, match="at least one"):
        CapSweepRunner(cfg, [0])
    runner = CapSweepRunner(cfg, [10, 0, -1, 3])
    assert runner.caps == [3, 10, 50] and runner.K == 4
    assert [runner.cap_labels[i] for i in runner.order] == [0, 3, 10, -1]


def test_cap_sweep_bec_chunk_tally_equals_jax(monkeypatch):
    B, p, labels = 64, 0.4, [0, 1, 3, 10, 40]
    u = np.random.default_rng(4).random((B, 1200)).astype(np.float32)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, prob, shape: jnp.asarray(u < prob))
    monkeypatch.setattr(torch, "rand",
                        lambda *a, **kw: torch.from_numpy(u.copy()))
    common = dict(channel="bec", code=FLAG, decoder="SPA", codeword=0,
                  batch=B)
    jr = jax_cap_sweep.CapSweepRunner(
        jax_runner.RunConfig(kernel="xla", **common), labels)
    want = np.asarray(jr._chunk_body(jax.random.PRNGKey(0), 1, p))
    pr = CapSweepRunner(RunConfig(device="cpu", **common), labels)
    got = pr._chunk(p, None).numpy()
    assert got.shape == (2, len(labels))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == B and got[0, -1] < B


def test_cap_sweep_msa_bf16_chunk_tally_equals_jax(monkeypatch):
    """biAWGN MSA bf16 against the JAX runner on its Pallas route
    (interpret mode), whose planes the port equals bit for bit."""
    B, snr, labels = 64, 2.0, [0] + PCAPS
    noise = np.random.default_rng(20).standard_normal(
        (B, 1200)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(torch, "randn",
                        lambda *a, **kw: torch.from_numpy(noise.copy()))
    common = dict(channel="biawgn", code=FLAG, decoder="MSA", codeword=1,
                  batch=B, msg_dtype="bfloat16")
    jr = jax_cap_sweep.CapSweepRunner(
        jax_runner.RunConfig(kernel="pallas", **common), labels)
    want = np.asarray(jr._chunk_body(jax.random.PRNGKey(0), 1, snr))
    pr = CapSweepRunner(RunConfig(device="cpu", **common), labels)
    got = pr._chunk(snr, None).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == B and got[1, 0] == B * 1200     # label 0: all bits


@pytest.mark.parametrize("case", ["HMG", "MAR", "REG_BAD", "REG_ENS",
                                  "IREG_ENS"])
def test_campaign_emit_equals_jax(case, capsys):
    jax_campaign.main([case, "--emit"])
    want = capsys.readouterr().out
    campaign.main([case, "--emit"])
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) >= 8
    assert campaign.all_cases.keys() == jax_campaign.all_cases.keys()


def test_campaign_refuses_unported():
    # The ensemble cases plan every member's five legs, rotating by default
    # and joint on request; IREG_ENS at cap 100, REG_ENS at 10.
    for joint, kind in ((False, "rotating"), (True, "joint")):
        plan = campaign._plan(["REG_ENS", "IREG_ENS"], True, joint)
        assert len(plan) == 2 * 5
        for case, cap in (("REG_ENS", 10), ("IREG_ENS", 100)):
            legs = [(cfg, extra) for name, k, cfg, extra in plan
                    if name == case and k == kind]
            assert [(c.channel, c.decoder) for c, _ in legs] == \
                [(c.channel, c.decoder) for c in campaign.def_cases(case)]
            assert all(c.max_iter == cap and c.code == case and
                       m == campaign.ENSEMBLE_MEMBERS[case] for c, m in legs)
            member_legs = sorted((m, c.channel, c.decoder, c.max_iter)
                                 for c, members in legs for m in members)
            assert len(member_legs) == 50
            assert member_legs == sorted(
                (c.code, c.channel, c.decoder, c.max_iter)
                for c in campaign.all_cases.get(case)())
    # HMG (ML, LP, SPA, MSA, ADMM) and MAR (ADMM + the five BP legs) plan
    # whole; only ADMMA is left without a port.
    plan = campaign._plan(["HMG", "MAR"], True)
    assert len(plan) == 14 + 8
    assert {cfg.decoder for _, _, cfg, _ in plan} == {"ML", "LP", "SPA",
                                                      "MSA", "ADMM"}
    assert campaign._DECODER_ITEM == {"ADMMA": "A.13"}


@pytest.mark.parametrize("case,n_runs,param", [("HMG", 14, 0.3),
                                               ("MAR", 8, 0.45)])
def test_campaign_hmg_mar_run_cpu(tmp_path, case, n_runs, param):
    """HMG and MAR end to end at a tiny size (one sweep point per leg)."""
    res = campaign.run_campaign(
        [case], data_dir=str(tmp_path), device="cpu",
        overrides=dict(batch=8, min_wec=1, max_words=16, params=[param],
                       log_freq=1e9))
    assert len(res) == n_runs
    for (name, argv), leg in res.items():
        assert name == case and leg[param]["tot"] >= 8
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == n_runs
    admm = [n for n in names if "-ADMM-" in n]
    assert len(admm) == 3 and all(n.endswith("-3.0-1e-05-10-False.json")
                                  for n in admm)


def test_campaign_reg_bad_cap_sweep_cpu(tmp_path, monkeypatch):
    """REG_BAD end to end at a tiny size (one sweep point per leg): five
    CapSweepRunner legs write the 40 files of the grid; biAWGN legs run
    bf16 messages, BSC legs float32; the default batch is the JAX
    package's 2048 and the CLI's --batch / --min-wec override it."""
    seen = []
    with monkeypatch.context() as m:
        m.setattr(CapSweepRunner, "run", lambda self: seen.append(
            (self.cfg.channel, self.cfg.msg_dtype, self.cfg.batch,
             self.cfg.min_wec)) or {})
        campaign.run_campaign(["REG_BAD"], device="cpu")
        campaign.main(["REG_BAD", "--device", "cpu", "--batch", "8",
                       "--min-wec", "7"])
    legs = [("bec", "float32"), ("bsc", "float32"), ("biawgn", "bfloat16"),
            ("bsc", "float32"), ("biawgn", "bfloat16")]
    assert seen == ([leg + (2048, 100) for leg in legs]
                    + [leg + (8, 7) for leg in legs])
    res = campaign.run_campaign(
        ["REG_BAD"], data_dir=str(tmp_path), device="cpu",
        overrides=dict(batch=8, min_wec=8, max_words=64, params=[0.45],
                       log_freq=1e9))
    assert len(res) == 5
    for (case, argv), leg in res.items():
        assert case == "REG_BAD" and argv.startswith("caps:")
        assert sorted(leg) == [0, 1, 2, 3, 6, 10, 40, 100]
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 40
    for lbl in (0, 1, 2, 3, 6, 10, 40, 100):
        assert f"bec-1200_3_6_ldpc-SPA-0-8-{lbl}.json" in names
        assert f"biawgn-1200_3_6_ldpc-MSA-1-8-{lbl}.json" in names
