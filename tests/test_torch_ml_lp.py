"""PyTorch port: the ML and LP decoders and the pseudo-codeword search
against the JAX package on the CPU.

- ML biAWGN: the decisions equal JAX's on the same y (ties have measure
  zero on real-valued scores);
- ML BSC / BEC: scores tie, and the two packages draw their tie-breaks
  from different random streams, so the port's pick must lie in the set
  JAX's scores leave open (its argmax set / its feasible set), and the
  pick must be uniform over that set (chi-square on a fixed seed, below
  its 0.1% point);
- LP: constraint arrays and vertex set equal to JAX's, decisions equal on
  the same LLRs, the vertex path against the ``linprog`` oracle;
- ``find_pcws``: the same pseudo-codeword set on Hamming(7,4) (LP: equal
  rows; ADMM: every row of either set within the search's dedupe radius
  of a row of the other).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ldpc_decoders_tpu import get_code as jax_get_code  # noqa: E402
from ldpc_decoders_tpu.decoders import lp as jax_lp  # noqa: E402
from ldpc_decoders_tpu.decoders import ml as jax_ml  # noqa: E402
from ldpc_decoders_tpu.decoders import pcw as jax_pcw  # noqa: E402
from ldpc_decoders_tpu_torch.channels import bec, biawgn, bsc  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.decoders import lp, ml, pcw  # noqa: E402


@pytest.fixture(scope="module")
def hamming():
    return get_code("7_4_hamming")


@pytest.fixture(scope="module")
def jax_hamming():
    return jax_get_code("7_4_hamming")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_ml_biawgn_equals_jax(hamming, jax_hamming):
    rng = np.random.default_rng(0)
    cb = hamming.cb
    x = cb[rng.integers(0, len(cb), 512)]
    y = ((2.0 * x - 1.0) + rng.standard_normal(x.shape)).astype(np.float32)
    want = np.asarray(jax_ml.MLBiAWGN(jax_hamming).decode(
        jnp.asarray(y), 2.0, jax.random.PRNGKey(0)))
    got = ml.MLBiAWGN(hamming).decode(torch.from_numpy(y), 2.0, _gen(0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != x).any()                # noise does cause errors


def test_ml_bsc_pick_lies_in_jax_argmax_set(hamming):
    rng = np.random.default_rng(1)
    y = rng.integers(0, 2, (512, 7))
    got = ml.MLBSC(hamming).decode(torch.from_numpy(y), 0.1, _gen(1)).numpy()
    # JAX's scores, by its own formula: affine and increasing in agreement
    cb_pm = 2.0 * hamming.cb - 1.0
    score = np.asarray(jnp.dot(jnp.asarray(2.0 * y - 1.0, jnp.float32),
                               jnp.asarray(cb_pm.T, jnp.float32)))
    best = score.max(axis=1)
    picked = (2.0 * y - 1.0) * (2.0 * got - 1.0)
    np.testing.assert_array_equal(picked.sum(axis=1), best)
    assert (got[:, None, :] == hamming.cb[None]).all(-1).any(-1).all()


def test_ml_bec_pick_is_feasible(hamming):
    rng = np.random.default_rng(2)
    x = hamming.cb[rng.integers(0, 16, 512)]
    y = np.where(rng.random(x.shape) < 0.5, 2, x)
    got = ml.MLBEC(hamming).decode(torch.from_numpy(y), 0.5, _gen(2)).numpy()
    known = y != 2
    assert (got[known] == y[known]).all()          # agrees where known
    assert (got[:, None, :] == hamming.cb[None]).all(-1).any(-1).all()
    assert (got != x).any()                        # ambiguous words exist


@pytest.mark.parametrize("decoder", ["bsc", "bec", "argmax"])
def test_ml_tie_break_is_uniform(hamming, decoder):
    """One received word with several tied codewords, 4000 times."""
    from scipy.stats import chi2 as chi2_dist

    n_rep = 4000
    if decoder == "argmax":
        vals = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 3.0]]).repeat(n_rep, 1)
        idx = ml.arg_max_rand_batched(vals, _gen(3)).numpy()
        counts = np.bincount(idx, minlength=6)[[1, 2, 4, 5]]
        assert counts.sum() == n_rep
    else:
        if decoder == "bec":
            # two known positions leave 16 / 4 = 4 feasible codewords
            y = np.array([1, 2, 2, 0, 2, 2, 2])
            dec = ml.MLBEC(hamming)
            feas = hamming.cb[(hamming.cb[:, 0] == 1) & (hamming.cb[:, 3] == 0)]
        else:
            # Hamming(7,4) is perfect (no BSC ties): take the (6,2) code
            # and the received word with the most nearest codewords.
            code = get_code("6_2_3_ldpc")
            words = (np.arange(64)[:, None] >> np.arange(6)) & 1
            dist = (words[:, None, :] != code.cb[None]).sum(axis=-1)
            ties = (dist == dist.min(axis=1, keepdims=True)).sum(axis=1)
            y = words[ties.argmax()]
            dec = ml.MLBSC(code)
            feas = code.cb[dist[ties.argmax()] == dist[ties.argmax()].min()]
        ys = torch.from_numpy(np.tile(y, (n_rep, 1)))
        got = dec.decode(ys, 0.1, _gen(4)).numpy()
        match = (got[:, None, :] == feas[None]).all(-1)
        assert match.any(-1).all()
        counts = match.sum(axis=0)
    k = len(counts)
    assert k >= 2
    chi2 = ((counts - n_rep / k) ** 2 / (n_rep / k)).sum()
    assert chi2 < chi2_dist.ppf(0.999, k - 1), (counts, chi2)


def test_lp_constraints_and_vertices_equal_jax(hamming, jax_hamming):
    a, b = lp.build_constraints(hamming.parity_mtx)
    ja, jb = jax_lp.build_constraints(jax_hamming.parity_mtx)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    dec = lp.LPDecoder(hamming.graph)
    jdec = jax_lp.LPDecoder(jax_hamming.graph)
    np.testing.assert_array_equal(dec.a_ub, jdec.a_ub)
    np.testing.assert_array_equal(dec.vertices, jdec.vertices)
    assert dec.host_only and dec.id_keys == jdec.id_keys
    # 4_2_test has degree-2 checks: no vertex path, linprog instead
    small = lp.LPDecoder(get_code("4_2_test").graph)
    assert small.vertices is None
    cb = get_code("4_2_test").cb
    gamma = np.log(0.9 / 0.1) * (1.0 - 2.0 * cb)
    np.testing.assert_array_equal(small.decode_batch(gamma), cb)


@pytest.mark.parametrize("allow_pseudo", [False, True])
def test_lp_decode_batch_equals_jax(hamming, jax_hamming, allow_pseudo):
    rng = np.random.default_rng(5)
    c = np.log(0.94 / 0.06)
    gammas = np.concatenate([rng.normal(0.0, 3.0, (200, 7)),
                             rng.choice([-c, c], size=(200, 7)),   # ties
                             rng.choice([-1e8, 0.0, 1e8], size=(100, 7))])
    got = lp.LPDecoder(hamming.graph,
                       allow_pseudo=allow_pseudo).decode_batch(gammas)
    want = jax_lp.LPDecoder(jax_hamming.graph,
                            allow_pseudo=allow_pseudo).decode_batch(gammas)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_lp_vertex_path_matches_linprog_oracle(hamming):
    dec = lp.LPDecoder(hamming.graph)
    assert dec.vertices is not None and len(dec.vertices) >= 16
    rng = np.random.default_rng(2)
    g_cont = rng.normal(0.0, 3.0, (100, 7))
    np.testing.assert_array_equal(dec._decode_batch_vertices(g_cont),
                                  dec._decode_batch_linprog(g_cont))
    c = np.log(0.94 / 0.06)
    g_disc = rng.choice([-c, c], size=(100, 7))
    frac = lp.LPDecoder(hamming.graph, allow_pseudo=True)
    ov = (frac._decode_batch_vertices(g_disc) * g_disc).sum(axis=1)
    ol = (frac._decode_batch_linprog(g_disc) * g_disc).sum(axis=1)
    np.testing.assert_allclose(ov, ol, atol=1e-6)


@pytest.mark.parametrize("decoder", ["LP", "ADMM"])
def test_find_pcws_equals_jax(hamming, jax_hamming, decoder):
    x = np.array([0, 1, 0, 0, 1, 0, 1])
    y = np.array([0, 1, 0, 1, 1, 0, 1])
    kw = dict(decoder=decoder, tries=128, seed=0, exclude=x[None, :])
    got = pcw.find_pcws(hamming, y, device="cpu", **kw)
    want = jax_pcw.find_pcws(jax_hamming, y, **kw)
    assert got.shape[0] >= 1 and got.shape[1] == 7
    if decoder == "LP":                            # the same numpy code
        np.testing.assert_array_equal(got, want)
    else:
        # Fixed points agree to the decoders' float32 tolerance (1e-4); a
        # row that one search kept and the other dropped lies within the
        # 1e-3 dedupe radius of a row the other kept.
        gap = np.abs(got[:, None, :] - want[None]).max(axis=-1)
        assert gap.min(axis=1).max() < 2e-3 and gap.min(axis=0).max() < 2e-3
    assert ((got > 1e-3) & (got < 1 - 1e-3)).any()


@pytest.mark.parametrize("mod,param", [(bsc, 0.1), (biawgn, 2.0), (bec, 0.3)])
def test_channel_factories(hamming, mod, param, tmp_path):
    """Every channel builds ML, LP, ADMM and ADMMA; their call shape is the
    runner's: decode(y, param, generator) -> (x_hat, aux)."""
    assert list(mod.DECODERS) == ["ML", "SPA", "MSA", "LP", "ADMM", "ADMMA"]
    gen = _gen(6)
    x = torch.ones((64, 7), dtype=torch.int32)
    y = mod.send(x, param, gen)
    x_ml, aux = mod.DECODERS["ML"](hamming, device="cpu").decode(y, param, gen)
    assert aux == {} and x_ml.shape == (64, 7)
    lp_dec = mod.DECODERS["LP"](hamming, device="cpu", max_iter=10)
    x_lp, aux = lp_dec.decode(y, param, gen)
    assert lp_dec.dec.host_only and aux == {} and isinstance(x_lp, np.ndarray)
    admm = mod.DECODERS["ADMM"](hamming, device="cpu", max_iter=200)
    x_admm, aux = admm.decode(y, param, gen)
    assert aux["iters"].shape == (64,) and admm.dec.track_iter_hist
    # ADMM solves the LP: the hard decisions agree wherever the LP optimum
    # is integral and unique, i.e. on most words.
    assert (x_admm.numpy() == x_lp).all(axis=1).mean() >= 0.8
    # ADMMA in train mode decodes with the exact projection: ADMM's output,
    # through the same LLR map of the channel.
    admma = mod.DECODERS["ADMMA"](hamming, device="cpu", max_iter=200,
                                  train=True, layers=[8],
                                  cache_dir=str(tmp_path))
    x_admma, aux_a = admma.decode(y, param, gen)
    assert torch.equal(x_admma, x_admm)
    assert torch.equal(aux_a["iters"], aux["iters"])
    assert admma.dec.track_iter_hist and admma.dec.stateful
    if mod is bec:
        table = bec.llr(torch.tensor([0, 1, 2]))
        assert table.tolist() == [1e8, -1e8, 0.0]
