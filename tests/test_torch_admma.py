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

The plain versions of the card's kernels (``ops/admm_step.py``,
``ops/mlp_kernel.py``), on the CPU:

- the loop split around the z-update (``admm_iter_pre_plain``,
  ``admm_iter_post_plain``, looped by ``admm_loop``) equals the loop as
  it was before the split bit for bit, with the exact and an MLP
  z-update, on Hamming(7,4) and a (3,6)-regular code of 36 variables;
- the plain training pass (``mlp_train_plain``) against ``jax.grad`` of
  the JAX loss: loss and gradients within 1e-5 relative per tensor;
- ``project_rows`` on a CPU tensor is ``project_parity_polytope``, bit for
  bit; a CPU decode, Adam step or offline training loads no kernel
  library; the kernels' wrappers refuse CPU tensors; the fused MLP's
  shared-memory plan and its refusal; the kernel build's hash covers the
  headers a source includes;
- K3's contract and plan: the plain dual update leaves a frozen word as
  given and does not count it (what lets the kernel pass over it); the
  launch plan takes every code of the repo at widths 1..8 within shared
  memory; the norms folded unit by unit equal ``word_sum`` bit for bit;
- the fused MLP kernel's split-TF32 products, emulated in plain PyTorch
  (TF32 rounding on the int32 view), against the JAX ``mlp_apply`` and
  ``jax.grad``: the forward within 1e-5, the loss and gradients within
  1e-5 relative.
"""

import itertools
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


# ----------------------------------------------------------------------
# The loop split around the z-update; the plain steps of the kernels
# ----------------------------------------------------------------------

def _pre_split_decode(llr, t, *, mu, eps, max_iter, n_edge, z_update):
    """``admm_decode_plain`` as it was before its iteration was split into
    ``admm_iter_pre_plain`` and ``admm_iter_post_plain``: one loop body."""
    from ldpc_decoders_tpu_torch.ops import admm_kernel as ak
    from ldpc_decoders_tpu_torch.ops.projection import fold_slots

    f32 = torch.float32
    B, V = llr.shape
    C, Dc = t.chk_var.shape
    mu_t = torch.full((), float(mu), dtype=f32)
    inv_mu = torch.full((), ak._inv_mu(mu), dtype=f32)
    thresh = torch.full((), ak._threshold(eps, n_edge), dtype=f32)
    var_deg = t.vmask.sum(dim=-1).to(f32)
    g = llr.to(f32) * inv_mu
    z = torch.where(t.cmask, 0.5, 0.0).to(f32).expand(B, C, Dc).contiguous()
    lam = torch.zeros((B, C, Dc), dtype=f32)
    x = torch.zeros((B, V), dtype=f32)
    done = torch.zeros(B, dtype=torch.bool)
    updates = torch.zeros(B, dtype=torch.int32)
    it = 0
    while it < max_iter and not bool(done.all()):
        lam_mu = lam * inv_mu
        u = (z - lam_mu).reshape(B, C * Dc)
        acc = torch.zeros((B, V), dtype=f32)
        for s in range(t.var_slot.shape[1]):
            acc = acc + torch.where(t.vmask[:, s], u[:, t.var_slot[:, s]],
                                    0.0)
        x_new = ((acc - g) / var_deg).clamp(0.0, 1.0)
        x_e = torch.where(t.cmask, x_new[:, t.chk_var], 0.0)
        v = x_e + lam_mu
        z_new = z_update(it, v)
        e1 = x_e - z_new
        e2 = z - z_new
        lam_new = lam + mu_t * e1
        d1 = ak.word_sum(fold_slots(e1 * e1))
        d2 = ak.word_sum(fold_slots(e2 * e2))
        close = (d1 < thresh) & (d2 < thresh)
        active = ~done
        x = torch.where(active[:, None], x_new, x)
        z = torch.where(active[:, None, None], z_new, z)
        lam = torch.where(active[:, None, None], lam_new, lam)
        updates += active.to(torch.int32)
        done = done | (active & close)
        it += 1
    iters = torch.where(done, updates - 1, updates)
    return (x > 0.5).to(torch.int32), iters, x


def _reg36_graph():
    """A (3,6)-regular code of 36 variables and 18 checks."""
    from ldpc_decoders_tpu_torch.codes.ensembles import rand_reg_ldpc
    from ldpc_decoders_tpu_torch.ops.graph import TannerGraph

    H = rand_reg_ldpc(36, 3, 6, rng=np.random.default_rng(5))
    return TannerGraph.from_parity_mtx(H)


def _awgn_llr(n, batch, snr_db, seed):
    rng = np.random.default_rng(seed)
    nv = 10.0 ** (-snr_db / 10.0)
    y = 1.0 + np.sqrt(nv) * rng.standard_normal((batch, n))
    return torch.from_numpy((-2.0 * y / nv).astype(np.float32))


@pytest.mark.parametrize("graph_name", ["7_4_hamming", "reg36"])
@pytest.mark.parametrize("z_kind", ["exact", "mlp"])
def test_split_loop_equals_pre_split_loop(graph_name, z_kind):
    """The plain halves of an iteration, looped by ``admm_loop``, give the
    pre-split loop's outputs bit for bit, with the exact projection and
    with an MLP (a seeded, untrained one: its rows differ from the
    exact projection's) as the z-update."""
    from ldpc_decoders_tpu_torch.ops import admm_kernel as ak
    from ldpc_decoders_tpu_torch.ops.graph import bp_tables

    graph = (get_code("7_4_hamming").graph if graph_name == "7_4_hamming"
             else _reg36_graph())
    t = bp_tables(graph)
    dim = graph.max_chk_deg
    llr = _awgn_llr(graph.n_var, 48, 2.0, seed=11)
    if z_kind == "exact":
        def z_update(it, v):
            return project_parity_polytope(v, mask=t.cmask)
    else:
        mlp = admma.mlp_init(dim, [8, 8], seed=3)

        def z_update(it, v):
            with torch.no_grad():
                return mlp(v.reshape(-1, dim)).reshape(v.shape)
    kw = dict(mu=3.0, eps=1e-5, max_iter=60, n_edge=graph.n_edge,
              z_update=z_update)
    want = _pre_split_decode(llr, t, **kw)
    got = ak.admm_decode_plain(llr, t, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if z_kind == "exact":       # some words converge before the cap
        assert int(want[1].min()) < 59
    # The halves leave their inputs alone and count the words left.
    z = torch.full((48,) + tuple(t.chk_var.shape), 0.5)
    lam = torch.zeros_like(z)
    g = llr * ak._inv_mu(3.0)
    inv_mu = torch.tensor(ak._inv_mu(3.0))
    x_new, x_e, v = ak.admm_iter_pre_plain(z, lam, g, t, inv_mu)
    state = (torch.zeros_like(x_new), z, lam, torch.zeros(48, dtype=torch.int32),
             torch.arange(48) % 2 == 0)
    copies = [s.clone() for s in state]
    out = ak.admm_iter_post_plain(*state[:3], x_new, x_e, z_update(0, v),
                                  *state[3:], t, torch.tensor(3.0),
                                  torch.tensor(1e9))
    for a, b in zip(state, copies):
        assert torch.equal(a, b)
    assert out[4].all() and int(out[5]) == 0       # all close at 1e9
    assert torch.equal(out[3], (torch.arange(48) % 2).to(torch.int32))


@pytest.mark.parametrize("layers", [[8, 8], [100, 100]])
def test_plain_train_step_equals_jax_grad(layers):
    """The fused MLP kernel's plain version (``mlp_train_plain``: the MLP's
    forward and autograd) against ``jax.grad`` of the JAX loss, 64 rows:
    the loss and each gradient within 1e-5 relative (the norm of the
    difference over the norm of the JAX gradient, per tensor)."""
    from ldpc_decoders_tpu_torch.ops import mlp_kernel

    rng = np.random.default_rng(9)
    rows = rng.normal(0.5, 0.8, (64, 6)).astype(np.float32)
    target = np.array(jax_projection.project_parity_polytope(
        jnp.asarray(rows)))
    jparams = jax_admma.mlp_init(jax.random.PRNGKey(4), 6, layers)

    def loss_fn(p):
        return jnp.mean((jax_admma.mlp_apply(p, jnp.asarray(rows))
                         - jnp.asarray(target)) ** 2)

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    mlp = admma.params_from_jax(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams])
    params = list(mlp.parameters())
    loss, grads = mlp_kernel.mlp_train(params, torch.from_numpy(rows),
                                       torch.from_numpy(target))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = [np.asarray(g[k]) for g in jgrads for k in ("w", "b")]
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        assert got.shape == w.shape
        rel = np.linalg.norm(got.numpy() - w) / np.linalg.norm(w)
        assert rel < 1e-5, rel
    # The forward route on the CPU is the MLP's own forward, bit for bit.
    with torch.no_grad():
        assert torch.equal(mlp_kernel.mlp_forward(params,
                                                  torch.from_numpy(rows)),
                           mlp(torch.from_numpy(rows)))


@pytest.mark.parametrize("dim", [2, 3, 4, 6, 8])
def test_project_rows_on_cpu_is_the_plain_projection(dim):
    from ldpc_decoders_tpu_torch.ops.admm_step import project_rows

    rng = np.random.default_rng(dim)
    v = torch.from_numpy(rng.normal(0.5, 0.8, (5, 40, dim))
                         .astype(np.float32))
    assert torch.equal(project_rows(v), project_parity_polytope(v))
    mask = torch.from_numpy(rng.random((40, dim)) < 0.8)
    assert torch.equal(project_rows(v, mask),
                       project_parity_polytope(v, mask=mask))


def test_cpu_routes_load_no_kernel_library(tmp_path, monkeypatch):
    """ADMMA on the CPU (train, eval, apprx), its Adam step and the offline
    trainer run the plain versions and never build or load a kernel."""
    import sys

    from ldpc_decoders_tpu_torch.ops import _build

    def no_library(name):
        raise AssertionError(f"a CPU route loaded the {name} kernel library")

    real = _build.load_library
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("ldpc_decoders_tpu_torch")
                and getattr(mod, "load_library", None) is real):
            monkeypatch.setattr(mod, "load_library", no_library)
    graph = get_code("7_4_hamming").graph
    llr = torch.from_numpy(_hamming_llr())
    train = admma.ADMMADecoder(graph, layers=[8], train=True, max_iter=20,
                               cache_dir=str(tmp_path), device="cpu")
    train.decode(llr)
    train.save()
    for apprx in (-1, 2):
        admma.ADMMADecoder(graph, layers=[8], apprx=apprx, max_iter=20,
                           cache_dir=str(tmp_path), device="cpu").decode(llr)
    admma.train_offline(4, [8], steps=3, batch=16, cache_dir=str(tmp_path),
                        log_every=0, device="cpu")


def test_mlp_plan_shrinks_the_tile_then_refuses():
    from ldpc_decoders_tpu_torch.ops import mlp_kernel

    assert mlp_kernel.mlp_plan([6, 100, 100, 6], False) == (64, 104672)
    assert mlp_kernel.mlp_plan([6, 100, 100, 6], True) == (128, 217344)
    # Wider layers take fewer rows per tile before the kernel refuses.
    assert mlp_kernel.mlp_plan([6, 140, 140, 6], True)[0] == 32
    assert mlp_kernel.mlp_plan([6, 147, 147, 6], True) == (16, 223584)
    assert mlp_kernel.mlp_plan([6, 152, 152, 6], True) == (16, 232224)
    assert mlp_kernel.mlp_plan([6, 158, 158, 6], True) == (8, 231024)
    with pytest.raises(ValueError, match="smallest row tile, 8 rows"):
        mlp_kernel.mlp_plan([6, 159, 159, 6], True)
    assert mlp_kernel.mlp_plan([6, 200, 200, 6], False)[0] == 32
    assert mlp_kernel.mlp_plan([6, 213, 213, 6], False) == (16, 232352)
    assert mlp_kernel.mlp_plan([6, 224, 224, 6], False) == (8, 229408)
    with pytest.raises(ValueError, match="too wide"):
        mlp_kernel.mlp_plan([6, 225, 225, 6], False)
    with pytest.raises(ValueError, match="layers"):
        mlp_kernel.mlp_plan([6] * 19, False)


def _ffma_form_smem_floats(sizes, tile, train):
    """The shared memory, in floats, of the fused MLP kernel's FFMA form
    (tiles of 64, 32, 16 or 8 rows), which the split-TF32 form replaced:
    weights in rows of a multiple of 16 floats, activation and gradient
    rows of tile + 4 floats, in training two gradient buffers of the
    widest layer but the input and the CTA's gradients unpadded."""
    def region(n):
        return -(-n // 4) * 4

    pairs = list(zip(sizes[:-1], sizes[1:]))
    row = tile + 4
    n = sum(region(n_in * -(-n_out // 16) * 16) + region(n_out)
            for n_in, n_out in pairs)
    if not train:
        return n + 2 * region(row * max(sizes))
    return (n + sum(region(row * (w + 1)) for w in sizes[:-1])
            + region(row * sizes[-1]) + 2 * region(row * max(sizes[1:]))
            + region(tile * sizes[-1])
            + sum(region((n_in + 1) * n_out) for n_in, n_out in pairs))


@pytest.mark.parametrize("hidden,widths", [
    (1, range(1, 1300, 3)), (2, range(1, 300, 6)), (3, range(1, 200, 13))])
def test_mlp_plan_takes_every_net_the_ffma_form_took(hidden, widths):
    """Every net the FFMA form's layout fit in a block at its smallest
    tile, 8 rows, gets a plan, for hidden layers of every width on the
    grid and several input widths D."""
    from ldpc_decoders_tpu_torch.ops import mlp_kernel
    from ldpc_decoders_tpu_torch.ops.geometry import SMEM_PER_CTA

    taken = 0
    for dim in (1, 3, 6, 16, 64, 100):
        for hs in itertools.product(widths, repeat=hidden):
            sizes = [dim, *hs, dim]
            for train in (False, True):
                if 4 * _ffma_form_smem_floats(sizes, 8, train) \
                        > SMEM_PER_CTA:
                    continue
                tile, smem = mlp_kernel.mlp_plan(sizes, train)
                assert smem == 4 * mlp_kernel.smem_floats(sizes, tile, train)
                assert smem <= SMEM_PER_CTA
                taken += 1
    assert taken > 1000


def _tf32(x):
    """TF32 rounding of float32 values, as ``cvt.rna.tf32.f32`` does it:
    to nearest, ties away from zero, on the int32 view (add 0x1000, clear
    the low 13 bits)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32_mm(a, b, terms=3):
    """a @ b as ``csrc/mlp_fused.cu`` computes it: each operand split into
    big = tf32(x) and small = tf32(x - big), the product small @ big +
    big @ small + big @ big (``terms=1``: big @ big alone, plain TF32).
    TF32 products are exact in float32 and the sums here in float64,
    rounded to float32 once: the emulation holds the split's own error, not
    the order of the card's sums."""
    def mm(*pairs):
        return sum(p.double() @ q.double() for p, q in pairs).float()

    a_big, b_big = _tf32(a), _tf32(b)
    if terms == 1:
        return mm((a_big, b_big))
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return mm((a_small, b_big), (a_big, b_small), (a_big, b_big))


def _split_tf32_mlp(params, x, target, terms=3):
    """The MLP's forward, loss and every gradient with each product in
    split TF32, as the fused kernel takes them: the bias added in float32
    after the product, db as the weight gradient's row of a column of 1s,
    the hidden gradients masked where the activation is 0."""
    ws, bs = params[0::2], params[1::2]
    acts = [x]
    for i, (w, b) in enumerate(zip(ws, bs)):
        z = _split_tf32_mm(acts[-1], w, terms) + b
        acts.append(torch.sigmoid(z) if i + 1 == len(ws) else torch.relu(z))
    y = acts[-1]
    loss = torch.mean((y - target) ** 2)
    d = (2.0 / y.numel()) * (y - target) * (y * (1.0 - y))
    grads = []
    for i in range(len(ws) - 1, -1, -1):
        a1 = torch.cat([acts[i], torch.ones_like(acts[i][:, :1])], 1)
        gw = _split_tf32_mm(a1.T.contiguous(), d, terms)
        grads = [gw[:-1], gw[-1]] + grads
        if i > 0:
            d = _split_tf32_mm(d, ws[i].T.contiguous(), terms) \
                * (acts[i] > 0)
    return y, loss, grads


@pytest.mark.parametrize("dim,layers", [(6, [100, 100]), (4, [64, 64])])
def test_split_tf32_products_keep_float32_accuracy(dim, layers):
    """The fused kernel's arithmetic, emulated in plain PyTorch on the CPU:
    every product of the forward and of the training pass in split TF32
    (three TF32 products a multiply-add) stays within 1e-5 of the JAX
    ``mlp_apply`` (absolute) and of ``jax.grad`` of the JAX loss (loss and
    each gradient relative, the norm of the difference over the JAX
    gradient's), on 4096 numpy-seeded rows. Plain TF32 (one product) does
    not: its forward misses the 1e-5 bar."""
    rng = np.random.default_rng(14)
    rows = rng.normal(0.5, 0.8, (4096, dim)).astype(np.float32)
    target = np.array(jax_projection.project_parity_polytope(
        jnp.asarray(rows)))
    jparams = jax_admma.mlp_init(jax.random.PRNGKey(5), dim, layers)

    def loss_fn(p):
        return jnp.mean((jax_admma.mlp_apply(p, jnp.asarray(rows))
                         - jnp.asarray(target)) ** 2)

    jout = np.asarray(jax_admma.mlp_apply(jparams, jnp.asarray(rows)))
    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    params = [torch.from_numpy(np.array(g[k])) for g in jparams
              for k in ("w", "b")]
    x, t = torch.from_numpy(rows), torch.from_numpy(target)
    out, loss, grads = _split_tf32_mlp(params, x, t)
    assert float(np.abs(out.numpy() - jout).max()) <= 1e-5
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = [np.asarray(g[k]) for g in jgrads for k in ("w", "b")]
    for got, w in zip(grads, want):
        assert got.shape == w.shape
        assert np.linalg.norm(got.numpy() - w) / np.linalg.norm(w) < 1e-5
    out1, _, _ = _split_tf32_mlp(params, x, t, terms=1)
    assert float(np.abs(out1.numpy() - jout).max()) > 1e-5


def test_relu_ties_decide_gradients_over_many_rows():
    """Over 100,003 rows of [6, 158, 158, 6] a few hidden pre-activations
    lie within float32's rounding of 0, and deciding one such relu the
    other way moves a gradient summed over the rows by more than 1e-5
    relative: the plain MLP in float32 and the kernel's split-TF32
    arithmetic (emulated) both miss 1e-5 against float64 on these rows.
    On the rows that the card tests keep (``off_relu_ties``: no hidden
    pre-activation within 2^-17 of its terms' magnitude of 0) both are
    within 1e-5 of float64 for every gradient."""
    from ldpc_decoders_tpu_torch.ops import mlp_kernel
    from ldpc_decoders_tpu_torch.ops.admm_step import project_rows
    from tests.test_torch_cuda import off_relu_ties

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(0.5, 0.8, (100_003, 6))
                         .astype(np.float32))
    params = [p.detach() for p in admma.mlp_init(6, [158, 158], 6,
                                                 device="cpu").parameters()]

    def errors(x):
        t = project_rows(x)
        _, want = mlp_kernel.mlp_train_plain(
            [p.double().requires_grad_(True) for p in params], x.double(),
            t.double())
        _, plain = mlp_kernel.mlp_train_plain(
            [p.clone().requires_grad_(True) for p in params], x, t)
        split = _split_tf32_mlp(params, x, t)[2]
        return [max(float((g.double() - w).norm() / w.norm())
                    for g, w in zip(grads, want)) for grads in (plain, split)]

    assert min(errors(x)) > 1e-5
    keep = off_relu_ties(params, x)
    assert 0 < int((~keep).sum()) < 2000
    assert max(errors(x[keep].contiguous())) < 1e-5


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """Editing a header a kernel source includes renames its build, so the
    source is rebuilt; a source that does not include it keeps its name."""
    from ldpc_decoders_tpu_torch.ops import _build

    (tmp_path / "a.cu").write_text('#include "h.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    assert _build.source_files("a") == ["a.cu", "h.cuh", "g.cuh"]
    before = {n: _build.library_path(n) for n in "ab"}
    (tmp_path / "g.cuh").write_text("// two\n")
    assert _build.library_path("a") != before["a"]
    assert _build.library_path("b") == before["b"]
    # The port's ADMM kernels include their shared header.
    monkeypatch.undo()
    for name in ("admm_decode", "admm_step"):
        assert "admm_row.cuh" in _build.source_files(name)
    assert ("-I", _build.CSRC_DIR) == _build.NVCC_FLAGS[-2:]


def test_kernel_wrappers_refuse_cpu_tensors():
    """K1-K4's wrappers take CUDA tensors only: a CPU tensor raises before
    any kernel is built (the routes send CPU tensors to the plain
    versions)."""
    from ldpc_decoders_tpu_torch.ops import admm_step, mlp_kernel
    from ldpc_decoders_tpu_torch.ops.graph import bp_tables

    t = bp_tables(get_code("7_4_hamming").graph)
    st = admm_step.step_tables(t)
    z = torch.zeros((2, 3, 4))
    g = torch.zeros((2, 7))
    params = list(admma.mlp_init(4, [8]).parameters())
    rows = torch.zeros((5, 4))
    calls = [
        lambda: admm_step.admm_iter_pre_cuda(z, z, g, st, 1 / 3),
        lambda: admm_step.project_rows_cuda(z),
        lambda: admm_step.admm_iter_post_cuda(
            g, z, z, g, None, z, torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.bool), st, 3.0, 1e-9),
        lambda: mlp_kernel.mlp_forward_cuda(params, rows),
        lambda: mlp_kernel.mlp_train_cuda(params, rows, rows),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("name,batch", [("7_4_hamming", 9),
                                        ("1200_3_6_ldpc", 6),
                                        ("1200_rho_x5_rand_ldpc_3", 7)])
def test_plain_post_leaves_frozen_words_as_given(name, batch):
    """``admm_iter_post_plain`` on a batch of frozen and running words
    (some of the running ones at a fixed point, so they converge now):
    every frozen word's x, z, lam and update count come back bit for bit
    as given and stay done, and ``left`` counts only the running words not
    done after the iteration. K3 skips frozen words on the card and relies
    on exactly this."""
    from ldpc_decoders_tpu_torch.ops import admm_kernel as ak
    from ldpc_decoders_tpu_torch.ops.graph import bp_tables

    t = bp_tables(get_code(name).graph)
    C, Dc = t.chk_var.shape
    V = t.var_slot.shape[0]
    rng = np.random.default_rng(batch)
    cm = t.cmask.numpy()

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32))

    x_new = f32(rng.random((batch, V)))
    x_e = torch.where(t.cmask, x_new[:, t.chk_var], 0.0)
    fixed = torch.as_tensor(np.arange(batch) % 3 == 0)[:, None, None]
    z_new = torch.where(fixed, x_e,
                        f32(np.where(cm, rng.random((batch, C, Dc)), 0)))
    state = (f32(rng.random((batch, V))),
             torch.where(fixed, x_e, f32(np.where(
                 cm, rng.random((batch, C, Dc)), 0))),
             f32(np.where(cm, rng.normal(0, 0.3, (batch, C, Dc)), 0)),
             torch.as_tensor(rng.integers(0, 50, batch), dtype=torch.int32),
             torch.as_tensor(rng.random(batch) < 0.5))
    frozen = state[4].clone()
    assert 0 < int(frozen.sum()) < batch
    out = ak.admm_iter_post_plain(
        *state[:3], x_new, x_e, z_new, *state[3:], t, torch.tensor(3.0),
        torch.tensor(ak._threshold(1e-5, int(cm.sum()))))
    for a, b in zip(out[:4], state[:4]):
        assert torch.equal(a[frozen], b[frozen])
    assert bool(out[4][frozen].all())
    assert int(out[5]) == int((~out[4]).sum())
    running = ~frozen
    assert torch.equal(out[3][running], state[3][running] + 1)
    assert bool(out[4][running & fixed[:, 0, 0]].all())


def test_post_plan_takes_every_code_within_shared_memory():
    """K3's launch plan takes every code under ``data/codes`` (and
    Hamming(7,4)), and every check row width 1..8 at those sizes, at the
    wrapper's rows per unit and at the most a CTA allows (992): whole runs
    of 32 rows per unit, as few units per word as that allows and of equal
    runs, a plane with room for a unit's slots shifted by up to 3 and
    16-byte aligned, 2 stages within the 227 KB an SM gives a CTA."""
    from ldpc_decoders_tpu_torch.ops import admm_step
    from ldpc_decoders_tpu_torch.ops.geometry import MAX_THREADS, SMEM_PER_CTA
    from ldpc_decoders_tpu_torch.ops.graph import bp_tables

    codes = os.path.join(os.path.dirname(__file__), "..", "data", "codes")
    names = sorted(f[:-4] for f in os.listdir(codes) if f.endswith(".txt"))
    sizes = set()
    for name in names + ["7_4_hamming"]:
        C, Dc = bp_tables(get_code(name).graph).chk_var.shape
        sizes |= {(C, Dc)} | {(C, d) for d in range(1, 9)}
    assert (1320, 6) in sizes and (599, 6) in sizes
    for (C, Dc), max_rows in itertools.product(
            sorted(sizes), (admm_step.POST_ROWS, MAX_THREADS - 32)):
        p = admm_step.post_plan(C, Dc, max_rows)
        units = -(-C // p.rows)
        assert p.rows % 32 == 0 and p.threads == p.rows + 32 <= MAX_THREADS
        assert (units - 1) * p.rows < C <= units * p.rows <= units * max_rows
        assert p.rows - 32 < -(-C // units)        # runs shared out evenly
        assert units == -(-(-(-C // 32)) // (max_rows // 32))
        assert p.plane % 4 == 0 and p.plane >= p.rows * Dc + 3
        assert p.smem_bytes <= SMEM_PER_CTA
        assert p.smem_bytes == 4 * admm_step.POST_STAGES * (
            3 * p.plane + 2 * p.rows // 8) + admm_step.POST_STATIC_BYTES
    assert admm_step.post_plan(600, 6).rows == 224
    with pytest.raises(ValueError):
        admm_step.post_plan(600, 9)
    with pytest.raises(ValueError):
        admm_step.post_plan(600, 6, max_rows=48)


@pytest.mark.parametrize("C,rows", [(600, 992), (600, 256), (600, 64),
                                    (1320, 992), (599, 96), (3, 992),
                                    (1001, 512)])
def test_post_units_fold_norms_in_word_sum_order(C, rows):
    """K3 folds a word's norms unit by unit: a unit's 8-row block sums by
    the strides 4, 2, 1, block b added to lane b mod 32's sum in ascending
    order across the units, then the 32 lanes halved. That equals
    ``admm_kernel.word_sum`` bit for bit at every unit size (a unit starts
    at a multiple of 32 rows, so the lanes it feeds shift by 4 a run)."""
    from ldpc_decoders_tpu_torch.ops import admm_kernel as ak
    from ldpc_decoders_tpu_torch.ops import admm_step

    plan = admm_step.post_plan(C, 6, max_rows=rows)
    rng = np.random.default_rng(C + rows)
    vals = torch.as_tensor(rng.random((5, C)).astype(np.float32) ** 3)
    lanes = torch.zeros((5, 32))
    for r0 in range(0, C, plan.rows):
        unit = vals[:, r0:r0 + plan.rows]
        unit = ak._pad_to(unit, 8).reshape(5, -1, 8)
        for m in (4, 2, 1):       # lane 0 of each block after the shuffles
            unit = unit + unit[..., torch.arange(8) ^ m]
        blocks = unit[..., 0]
        for j in range(blocks.shape[1]):
            lane = (r0 // 8 + j) % 32
            lanes[:, lane] = lanes[:, lane] + blocks[:, j]
    for m in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(32) ^ m]
    assert torch.equal(lanes[:, 0], ak.word_sum(vals))
