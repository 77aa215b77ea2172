"""PyTorch port: ADMMA (ADMM with a learned projection) against the port's
ADMM and against the JAX package's ADMMA, on the CPU.

The same numpy-seeded inputs go through both packages. What is exact and
what has a tolerance:

- train mode decodes with the exact projection, so the port's ADMMA equals
  the port's ``ADMMDecoder`` bit for bit (decisions, iteration counts and
  the fractional x), on Hamming(7,4) and LDPC(1200,3,6);
- against the JAX ADMMA, with the parameters carried across by
  ``params_from_jax``: decisions equal word for word and iteration counts
  equal on every word. The fractional x agrees within ``ATOL_X_EVAL`` in
  eval mode (the MLP is in the loop at every iteration, and its products,
  the x-update's sums and the port's product with 1/mu round apart from
  the JAX package's in the last bits) and within ``ATOL_X`` in train mode
  and with ``apprx=3`` (the exact projection decodes, or takes over after
  iteration 3). The parameters after train-mode decoding, 30 Adam steps on
  rows that differ in the last bits, agree within ``ATOL_TRAINED``;
- one training step from the same parameters and rows: the gradient within
  a relative error of 1e-5 (the norm of the difference over the norm of
  the JAX gradient, per tensor), one ``torch.optim.Adam`` step within 1e-6
  of one ``optax.adam`` step, given the same gradient and given each
  package's own;
- npz checkpoints load in both directions, the forward within 1e-6;
- the offline trainer reaches the JAX test's own bar, MSE < 5e-3 against
  the exact projection at dim 4, [64, 64], 1500 steps of 512 rows.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ldpc_decoders_tpu import get_code as jax_get_code  # noqa: E402
from ldpc_decoders_tpu import main as jax_main  # noqa: E402
from ldpc_decoders_tpu.channels import bsc as jax_bsc  # noqa: E402
from ldpc_decoders_tpu.decoders import admma as jax_admma  # noqa: E402
from ldpc_decoders_tpu.harness import MonteCarloRunner as JaxRunner  # noqa: E402
from ldpc_decoders_tpu.harness import RunConfig as JaxRunConfig  # noqa: E402
from ldpc_decoders_tpu.ops import projection as jax_projection  # noqa: E402
from ldpc_decoders_tpu_torch import main as port_main  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.decoders import admma  # noqa: E402
from ldpc_decoders_tpu_torch.decoders.admm import ADMMDecoder  # noqa: E402
from ldpc_decoders_tpu_torch.harness import MonteCarloRunner, RunConfig  # noqa: E402
from ldpc_decoders_tpu_torch.ops.projection import project_parity_polytope  # noqa: E402

ATOL_X_EVAL = 1e-4
ATOL_X = 1e-5
ATOL_TRAINED = 2e-4
REPO = os.path.join(os.path.dirname(__file__), "..")
COMMITTED_CACHE = os.path.join(REPO, "cache")       # model_6-100-100-6.npz


def _hamming_llr():
    code = jax_get_code("7_4_hamming")
    return np.array(jax_bsc.llr(jnp.asarray(code.cb), 0.05))


def _ldpc_llr(batch=32, snr_db=2.5, seed=0):
    """biAWGN LLRs of codeword 1 on LDPC(1200,3,6), in float32."""
    rng = np.random.default_rng(seed)
    nv = 10.0 ** (-snr_db / 10.0)
    y = 1.0 + np.sqrt(nv) * rng.standard_normal((batch, 1200))
    return (-2.0 * y / nv).astype(np.float32)


CASES = {"7_4_hamming": _hamming_llr, "1200_3_6_ldpc": _ldpc_llr}


def _carry(dec, jax_params):
    """Give a port decoder the JAX decoder's parameters and a fresh Adam."""
    dec.mlp = admma.params_from_jax(
        [{k: np.asarray(v) for k, v in p.items()} for p in jax_params])
    dec.opt = admma.make_adam(dec.mlp, 1e-3)


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """A dim-4 [64, 64] model trained by the JAX package's own trainer."""
    cache = str(tmp_path_factory.mktemp("jax_cache"))
    jax_admma.train_offline(4, [64, 64], steps=1500, batch=512,
                            cache_dir=cache, log_every=0)
    return cache


@pytest.fixture(scope="module")
def port_cache(tmp_path_factory):
    """The same model trained by the port's trainer, on the CPU."""
    cache = str(tmp_path_factory.mktemp("port_cache"))
    admma.train_offline(4, [64, 64], steps=1500, batch=512, cache_dir=cache,
                        log_every=0, device="cpu")
    return cache


# ----------------------------------------------------------------------
# Train mode == the port's ADMM, bit for bit
# ----------------------------------------------------------------------

@pytest.mark.parametrize("code_name", list(CASES))
def test_train_mode_equals_port_admm(code_name, tmp_path):
    code = get_code(code_name)
    llr = torch.from_numpy(CASES[code_name]())
    for allow_pseudo in (False, True):
        exact = ADMMDecoder(code.graph, max_iter=30,
                            allow_pseudo=allow_pseudo, device="cpu")
        learned = admma.ADMMADecoder(
            code.graph, max_iter=30, allow_pseudo=allow_pseudo, train=True,
            layers=[16], cache_dir=str(tmp_path), device="cpu")
        w0 = learned.mlp.w0.detach().clone()
        x_e, it_e = exact.decode(llr)
        x_a, it_a = learned.decode(llr)
        assert torch.equal(x_e, x_a)           # decisions / fractional x
        assert torch.equal(it_e, it_a)
        assert not torch.equal(w0, learned.mlp.w0)   # the MLP trained
    if code_name == "7_4_hamming":
        assert (x_a == torch.as_tensor(code.cb, dtype=x_a.dtype)).all()


# ----------------------------------------------------------------------
# Against the JAX ADMMA
# ----------------------------------------------------------------------

@pytest.mark.parametrize("code_name", list(CASES))
@pytest.mark.parametrize("mode", ["eval", "apprx3", "train"])
def test_admma_equals_jax(code_name, mode, jax_cache):
    """allow_pseudo=True gives each package's fractional x; the decisions
    of allow_pseudo=False are x > 0.5 of the same x (the snap within 1e-8
    of 0 or 1 moves no value across 0.5)."""
    if code_name == "7_4_hamming":
        cache, layers, kw = jax_cache, [64, 64], dict(max_iter=100)
    else:        # the committed dim-6 model
        cache, layers, kw = COMMITTED_CACHE, [100, 100], dict(max_iter=30)
    if mode == "apprx3":
        kw = dict(kw, apprx=3)
    train = mode == "train"
    gamma = CASES[code_name]()
    jdec = jax_admma.ADMMADecoder(jax_get_code(code_name).graph, layers=layers,
                                  cache_dir=cache, allow_pseudo=True,
                                  train=train, **kw)
    pdec = admma.ADMMADecoder(get_code(code_name).graph, layers=layers,
                              cache_dir=cache, allow_pseudo=True,
                              train=train, device="cpu", **kw)
    if train:
        _carry(pdec, jdec.params)
    else:               # the checkpoint, as the JAX package loads it
        want = admma.params_from_jax(jax_admma.load_params(
            jax_admma.ckpt_path(cache, pdec.dim, layers)))
        for k, v in want.state_dict().items():
            assert torch.equal(v, pdec.mlp.state_dict()[k])
    x_j, it_j = (np.asarray(a) for a in jdec.decode(jnp.asarray(gamma)))
    x_p, it_p = (a.numpy() for a in pdec.decode(torch.from_numpy(gamma)))
    np.testing.assert_array_equal(x_p > 0.5, x_j > 0.5)
    np.testing.assert_array_equal(it_p, it_j)
    np.testing.assert_allclose(x_p, x_j, rtol=0,
                               atol=ATOL_X if mode != "eval" else ATOL_X_EVAL)
    if train:
        for p_j, p_p in zip(jdec.params, admma.params_to_jax(pdec.mlp)):
            for k in ("w", "b"):
                np.testing.assert_allclose(p_p[k], np.asarray(p_j[k]),
                                           rtol=0, atol=ATOL_TRAINED)


# ----------------------------------------------------------------------
# One training step
# ----------------------------------------------------------------------

def test_one_training_step_equals_jax():
    rng = np.random.default_rng(3)
    rows = rng.normal(0.5, 0.8, (3000, 6)).astype(np.float32)
    target = np.array(jax_projection.project_parity_polytope(
        jnp.asarray(rows)))
    jparams = jax_admma.mlp_init(jax.random.PRNGKey(1), 6, [100, 100])

    def loss_fn(p):
        return jnp.mean((jax_admma.mlp_apply(p, jnp.asarray(rows))
                         - jnp.asarray(target)) ** 2)

    jgrads = jax.grad(loss_fn)(jparams)
    opt = optax.adam(1e-3)
    upd, _ = opt.update(jgrads, opt.init(jparams), jparams)
    jstep = optax.apply_updates(jparams, upd)

    mlp = admma.params_from_jax(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams])
    loss = torch.mean((mlp(torch.from_numpy(rows))
                       - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_fn(jparams)),
                               rtol=1e-6)
    for i, g in enumerate(jgrads):
        for k in ("w", "b"):
            want = np.asarray(g[k])
            got = getattr(mlp, f"{k}{i}").grad.numpy()
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel < 1e-5, (k, i, rel)

    # One Adam step: from the same gradient, and from each package's own.
    own = admma.params_from_jax(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams])
    admma.adam_step(own, admma.make_adam(own, 1e-3), torch.from_numpy(rows),
                    torch.from_numpy(target))
    for i, g in enumerate(jgrads):
        for k in ("w", "b"):
            getattr(mlp, f"{k}{i}").grad = torch.from_numpy(
                np.array(g[k]))
    admma.make_adam(mlp, 1e-3).step()
    for i, p in enumerate(jstep):
        for k in ("w", "b"):
            for net in (mlp, own):
                np.testing.assert_allclose(
                    getattr(net, f"{k}{i}").detach().numpy(),
                    np.asarray(p[k]), rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# Checkpoints, forward, offline training
# ----------------------------------------------------------------------

def test_checkpoints_load_both_ways(tmp_path):
    x = np.random.default_rng(0).random((256, 6)).astype(np.float32)
    jparams = jax_admma.mlp_init(jax.random.PRNGKey(2), 6, [32, 16])
    path = jax_admma.ckpt_path(str(tmp_path / "jax"), 6, [32, 16])
    jax_admma.save_params(path, jparams)
    mlp = admma.load_params(path)
    assert mlp.sizes == [6, 32, 16, 6]
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_admma.mlp_apply(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    port = admma.mlp_init(6, [32, 16], seed=5)
    path = admma.ckpt_path(str(tmp_path / "port"), 6, [32, 16])
    admma.save_params(path, port)
    assert os.path.basename(path) == "model_6-32-16-6.npz"
    back = jax_admma.load_params(path)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_admma.mlp_apply(back, jnp.asarray(x))),
        rtol=0, atol=1e-6)
    for p_j, p_p in zip(back, admma.params_to_jax(port)):
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(p_j[k]), p_p[k])
    # The committed checkpoint loads too, as both packages read it.
    mlp = admma.load_params(admma.ckpt_path(COMMITTED_CACHE, 6, [100, 100]))
    want = jax_admma.load_params(
        jax_admma.ckpt_path(COMMITTED_CACHE, 6, [100, 100]))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_admma.mlp_apply(want, jnp.asarray(x))),
        rtol=0, atol=1e-6)


def test_mlp_init_is_glorot_and_seeded():
    a = admma.mlp_init(6, [100, 50], seed=0)
    b = admma.mlp_init(6, [100, 50], seed=0)
    c = admma.mlp_init(6, [100, 50], seed=1)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
        if k.startswith("b"):
            assert (v == 0).all()
        else:
            n_in, n_out = v.shape
            scale = np.sqrt(6.0 / (n_in + n_out))
            assert float(v.abs().max()) <= scale
            assert float(v.abs().max()) > 0.9 * scale
            assert not torch.equal(v, c.state_dict()[k])
    assert [p.shape[0] for k, p in a.state_dict().items()
            if k.startswith("w")] == [6, 100, 50]


def test_offline_training_approximates_projection(port_cache):
    mlp = admma.load_params(admma.ckpt_path(port_cache, 4, [64, 64]))
    x = np.random.default_rng(0).random((256, 4)).astype(np.float32)
    y = np.asarray(jax_projection.project_parity_polytope(jnp.asarray(x)))
    with torch.no_grad():
        y_hat = mlp(torch.from_numpy(x)).numpy()
    assert np.mean((y - y_hat) ** 2) < 5e-3
    y_port = project_parity_polytope(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_port, y, rtol=0, atol=1e-6)


def test_offline_cli(tmp_path, capsys):
    admma.main(["3", "--layers", "8", "--steps", "20", "--batch", "64",
                "--cache_dir", str(tmp_path), "--device", "cpu"])
    assert "final loss" in capsys.readouterr().out
    assert os.listdir(str(tmp_path)) == ["model_3-8-3.npz"]


# ----------------------------------------------------------------------
# Eval-mode decoding, errors and names
# ----------------------------------------------------------------------

@pytest.mark.parametrize("apprx", [-1, 3])
def test_eval_mode_decodes_codewords(apprx, port_cache):
    code = get_code("7_4_hamming")
    kw = (dict(max_iter=100) if apprx < 0
          else dict(max_iter=-1, iter_cap=500, apprx=apprx))
    dec = admma.ADMMADecoder(code.graph, layers=[64, 64],
                             cache_dir=port_cache, device="cpu", **kw)
    w0 = dec.mlp.w0.detach().clone()
    x_hat, _ = dec.decode(torch.from_numpy(_hamming_llr()))
    ok = (x_hat.numpy() == code.cb).all(axis=1)
    if apprx < 0:
        assert ok.mean() >= 0.75, ok.mean()
    else:               # the exact projection finishes every word
        assert ok.all()
    assert torch.equal(w0, dec.mlp.w0)        # eval mode does not train


def test_admma_errors_and_checkpoint_name(tmp_path):
    with pytest.raises(ValueError, match="regular"):
        admma.ADMMADecoder(get_code("4_2_test").graph, train=True,
                           device="cpu")       # check degrees 2, 3, 2
    graph = get_code("7_4_hamming").graph
    missing = admma.ckpt_path(str(tmp_path / "none"), 4, [16])
    with pytest.raises(FileNotFoundError, match=missing):
        admma.ADMMADecoder(graph, layers=[16], cache_dir=str(tmp_path / "none"),
                           device="cpu")
    dec = admma.ADMMADecoder(graph, layers=[16], train=True,
                             cache_dir=str(tmp_path), device="cpu")
    assert dec.id_keys == jax_admma.ADMMADecoder.id_keys
    assert dec.track_iter_hist and dec.stateful
    path = dec.save()
    assert path.endswith("model_4-16-4.npz")
    # eval mode loads what train mode saved
    again = admma.ADMMADecoder(graph, layers=[16], cache_dir=str(tmp_path),
                               device="cpu")
    assert torch.equal(again.mlp.w1, dec.mlp.w1)


# ----------------------------------------------------------------------
# Through the harness and the CLI
# ----------------------------------------------------------------------

def test_harness_train_mode_persists_parameters(tmp_path):
    cfg = RunConfig(channel="bsc", code="7_4_hamming", decoder="ADMMA",
                    params=[0.05, 0.03], codeword=1, min_wec=10, batch=64,
                    max_iter=20, train=True, layers=[16],
                    cache_dir=str(tmp_path), log_freq=1e9, device="cpu")
    runner = MonteCarloRunner(cfg)
    dec = runner.dec.dec
    snaps = []
    orig = dec.decode

    def decode(llr):
        snaps.append(dec.mlp.w0.detach().clone())
        return orig(llr)

    dec.decode = decode
    res = runner.run()
    assert all(res[p]["wec"] >= 10 for p in cfg.params)
    assert all(len(res[p]["dec"]["iter"]) == 2000 for p in cfg.params)
    # Each chunk starts from where the previous one left the parameters.
    assert len(snaps) >= 3
    assert all(not torch.equal(a, b) for a, b in zip(snaps, snaps[1:]))
    assert not torch.equal(snaps[-1], dec.mlp.w0)
    assert runner.dec.dec.save().endswith("model_4-16-4.npz")


@pytest.mark.parametrize("layers", [(100, 100), [16]])
def test_saver_name_equals_jax_runner(layers, tmp_path):
    kw = dict(channel="biawgn", code="7_4_hamming", decoder="ADMMA",
              params=[3.0], codeword=1, min_wec=5, max_iter=50, train=True,
              layers=layers, cache_dir=str(tmp_path))
    port = MonteCarloRunner(RunConfig(device="cpu",
                                      data_dir=str(tmp_path / "p"), **kw))
    jax_runner = JaxRunner(JaxRunConfig(data_dir=str(tmp_path / "j"), **kw))
    name = os.path.basename(port.saver.file_path)
    assert name == os.path.basename(jax_runner.saver.file_path)
    assert port.id_keys == jax_runner.id_keys
    assert str(layers) in name


def test_cli_admma_train_writes_jax_named_json(tmp_path):
    argv = ["bsc", "7_4_hamming", "ADMMA", "--train", "--layers", "16",
            "--params", "0.05", "--codeword", "1", "--min-wec", "5",
            "--max-iter", "20", "--batch", "128", "--console",
            "--cache_dir", str(tmp_path / "cache")]
    res = port_main.main(argv + ["--device", "cpu",
                                 "--data_dir", str(tmp_path / "port")])
    jax_main.main(argv + ["--data_dir", str(tmp_path / "jax")])
    names = os.listdir(str(tmp_path / "port"))
    assert names == os.listdir(str(tmp_path / "jax"))
    assert names == ["bsc-7_4_hamming-ADMMA-1-5-3.0-1e-05-20-False-[16].json"]
    with open(os.path.join(str(tmp_path / "port"), names[0])) as fp:
        saved = json.load(fp)
    with open(os.path.join(str(tmp_path / "jax"), names[0])) as fp:
        want = json.load(fp)
    assert list(saved) == list(want)        # the JAX Saver schema
    assert saved["wec"]["0.05"] == res[0.05]["wec"] >= 5
    assert len(saved["dec"]["0.05"]["iter"]) == 2000
