"""PyTorch port: the Monte-Carlo chunk's passes around the decode
(``ops/chunk_kernel.py``: C1 ``transmit``, C2 ``tally``) on the CPU, where
they run their plain versions, against the JAX package.

- ``transmit_plain`` equals the JAX ``send`` then ``llr`` of each channel on
  the same draw (made with numpy and injected into both packages), for
  codewords 0, 1 and -1 (rows of the Hamming(7,4) codebook): biAWGN and
  BEC bit for bit; the BSC's symbols bit for bit and its LLRs within one
  ulp (``log1p`` and ``log`` of p may differ in the last bit between
  XLA-CPU and torch-CPU, as in ``tests/test_torch_channel.py``);
- it is the channel module's own chain, ``llr(send(x, p, gen), p)``, on
  the generator's draw;
- ``tally_plain`` equals the tallies of the JAX chunk bodies on the same
  decisions: the runner's ``[wec, bec]`` with the 2000-bin histogram
  (counts below 0, at 0, 1999 and above), the cap sweep's ``[2, K]`` with
  label 0, the joint ensemble's ``[2, A]``;
- a runner chunk with codeword -1 equals the JAX runner's;
- the CPU route builds and loads no kernel library; the kernels' wrappers
  refuse CPU tensors.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ldpc_decoders_tpu.channels import CHANNELS as JAX_CHANNELS  # noqa: E402
from ldpc_decoders_tpu.harness import cap_sweep as jax_cap_sweep  # noqa: E402
from ldpc_decoders_tpu.harness import ensemble_runner as jax_ens  # noqa: E402
from ldpc_decoders_tpu.harness import runner as jax_runner  # noqa: E402
from ldpc_decoders_tpu_torch.channels import CHANNELS  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.harness import MonteCarloRunner, RunConfig  # noqa: E402
from ldpc_decoders_tpu_torch.ops import _build, chunk_kernel  # noqa: E402

FLAG = "1200_3_6_ldpc"
HAMMING = "7_4_hamming"
PARAMS = {"biawgn": 2.0, "bsc": 0.05, "bec": 0.4}


def _draw(channel, shape, seed):
    rng = np.random.default_rng(seed)
    if channel == "biawgn":
        return rng.standard_normal(shape).astype(np.float32)
    return rng.random(shape).astype(np.float32)


def _inject(monkeypatch, channel, noise):
    """Both packages' draws return ``noise`` (the JAX BSC and BEC draw
    Bernoulli flags: ``noise < p``)."""
    if channel == "biawgn":
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype=None: jnp.asarray(noise))
        monkeypatch.setattr(torch, "randn",
                            lambda *a, **kw: torch.from_numpy(noise.copy()))
    else:
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, prob, shape: jnp.asarray(noise < prob))
        monkeypatch.setattr(torch, "rand",
                            lambda *a, **kw: torch.from_numpy(noise.copy()))


def _codewords(code_name, codeword, B, seed):
    """(x [B, n] int32, idx [B] int64 or None, cb [M, n] int32 or None)."""
    code = get_code(code_name)
    n = code.get_n()
    if codeword != -1:
        return np.full((B, n), codeword, np.int32), None, None
    cb = np.asarray(code.cb, np.int32)
    idx = np.random.default_rng(seed).integers(0, cb.shape[0], B)
    return cb[idx], idx, cb


# Codeword -1 needs a codebook: Hamming(7,4) has one, LDPC(1200,3,6) not.
@pytest.mark.parametrize("code_name,B,codeword", [
    (FLAG, 64, 0), (FLAG, 64, 1), (HAMMING, 256, 0), (HAMMING, 256, 1),
    (HAMMING, 256, -1)])
@pytest.mark.parametrize("channel", ["biawgn", "bsc", "bec"])
def test_transmit_plain_equals_jax(channel, code_name, B, codeword,
                                   monkeypatch):
    param = PARAMS[channel]
    x, idx, cb = _codewords(code_name, codeword, B, 5)
    noise = _draw(channel, x.shape, 6)
    _inject(monkeypatch, channel, noise)
    jmod = JAX_CHANNELS[channel]
    y_want = np.asarray(jmod.send(jax.random.PRNGKey(0), jnp.asarray(x),
                                  param))
    llr_want = np.asarray(jmod.llr(jnp.asarray(y_want), param))
    kw = dict(codeword=codeword,
              idx=None if idx is None else torch.from_numpy(idx),
              cb=None if cb is None else torch.from_numpy(cb))
    t_noise = torch.from_numpy(noise)
    y, gamma = chunk_kernel.transmit(channel, t_noise, param, want="both",
                                     **kw)
    assert gamma.dtype == torch.float32
    assert y.dtype == (torch.float32 if channel == "biawgn" else torch.int32)
    np.testing.assert_array_equal(y.numpy(), y_want)
    if channel == "bsc":
        np.testing.assert_array_max_ulp(gamma.numpy(), llr_want, maxulp=1)
        np.testing.assert_array_equal(np.signbit(gamma.numpy()),
                                      np.signbit(llr_want))
    else:
        np.testing.assert_array_equal(gamma.numpy(), llr_want)
    # Each output mode gives the same bits; ``out`` receives them.
    assert torch.equal(chunk_kernel.transmit(channel, t_noise, param,
                                             want="sym", **kw), y)
    out = torch.empty_like(gamma)
    assert chunk_kernel.transmit(channel, t_noise, param, out=out,
                                 **kw) is out
    assert torch.equal(out, gamma)


@pytest.mark.parametrize("channel", ["biawgn", "bsc", "bec"])
def test_transmit_plain_is_the_channel_chain(channel):
    """On a generator's draw, C1's plain version is the channel's own
    ``llr(send(x, p, gen), p)``; ``draw`` is the draw ``send`` takes."""
    mod, param = CHANNELS[channel], PARAMS[channel]
    x = torch.ones((32, 1200), dtype=torch.int32)
    want_y = mod.send(x, param, torch.Generator().manual_seed(3))
    want = mod.llr(want_y, param)
    noise = mod.draw(x.shape, torch.Generator().manual_seed(3), "cpu")
    y, gamma = chunk_kernel.transmit_plain(channel, noise, param, 1,
                                           want="both")
    assert torch.equal(y, want_y) and torch.equal(gamma, want)


def _decisions(x, seed, rate=0.002):
    """Decisions near the codewords x [..., B, n]: bit errors at ``rate``,
    some words wholly right."""
    rng = np.random.default_rng(seed)
    flips = rng.random(x.shape) < rate
    flips[..., ::3, :] = False
    return (x ^ flips).astype(np.int32)


@pytest.mark.parametrize("codeword", [0, 1, -1])
@pytest.mark.parametrize("hist", [False, True])
def test_tally_plain_equals_jax_chunk_body(codeword, hist):
    """The runner's tally on the same decisions: ``[wec, bec]`` and, for a
    decoder that tracks iterations, the histogram clipped at both ends."""
    B = 256
    code_name = HAMMING if codeword == -1 else FLAG
    x, idx, cb = _codewords(code_name, codeword, B, 7)
    x_hat = _decisions(x, 8, 0.05 if codeword == -1 else 0.002)
    iters = np.random.default_rng(9).integers(0, 40, B).astype(np.int32)
    iters[:5] = [-3, 0, 1999, 2000, 2500]
    fake = types.SimpleNamespace(
        cfg=types.SimpleNamespace(batch=B, codeword=codeword),
        track_hist=hist, _sample_x=lambda key, batch: jnp.asarray(x),
        mod=types.SimpleNamespace(send=lambda key, x, p: x),
        dec=types.SimpleNamespace(decode=lambda y, p, k: (
            jnp.asarray(x_hat), {"iters": jnp.asarray(iters)})))
    want = np.asarray(jax_runner.MonteCarloRunner._chunk_body(
        fake, jax.random.PRNGKey(0), 1, 0.0))
    got = chunk_kernel.tally(
        torch.from_numpy(x_hat), codeword,
        None if idx is None else torch.from_numpy(idx),
        None if cb is None else torch.from_numpy(cb),
        iters=torch.from_numpy(iters) if hist else None)
    assert got.dtype == torch.int64
    assert got.shape == ((2 + chunk_kernel.HIST_LEN,) if hist else (2,))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < got[0] < B
    if hist:
        h = got[2:].numpy()
        assert h[0] == int((iters <= 0).sum()) and h[1999] == 3


@pytest.mark.parametrize("channel", ["biawgn", "bsc", "bec"])
def test_tally_plain_cap_sweep_equals_jax(channel, monkeypatch):
    """The cap sweep's ``[2, K]``: label 0 scores the channel symbols on
    the BSC and BEC (C1's ``sym``), every bit on biAWGN; then the planes."""
    B, n, K, param = 128, 1200, 4, PARAMS[channel]
    x = np.zeros((B, n), np.int32)
    noise = _draw(channel, x.shape, 10)
    _inject(monkeypatch, channel, noise)
    planes = _decisions(np.broadcast_to(x, (K, B, n)), 11, 0.001)
    fake = types.SimpleNamespace(
        cfg=types.SimpleNamespace(batch=B, codeword=0, channel=channel),
        code=types.SimpleNamespace(get_n=lambda: n),
        mod=JAX_CHANNELS[channel], caps=[1, 2, 3, 10], n_zero=1,
        dec=types.SimpleNamespace(decode_multi_cap=lambda y, caps: (
            jnp.asarray(planes), None)))
    want = np.asarray(jax_cap_sweep.CapSweepRunner._chunk_body(
        fake, jax.random.PRNGKey(0), 1, param))
    raw = None
    if channel != "biawgn":
        raw = chunk_kernel.transmit(channel, torch.from_numpy(noise), param,
                                    want="sym")
    got = chunk_kernel.tally(torch.from_numpy(planes), 0, raw=raw,
                             all_wrong=raw is None)
    assert got.shape == (2, K + 1) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if channel == "biawgn":
        assert got[0, 0] == B and got[1, 0] == B * n


@pytest.mark.parametrize("codeword", [0, 1])
def test_tally_plain_ensemble_equals_jax(codeword):
    """The joint ensemble route's ``[2, A]``, a column per member."""
    A, B, n = 10, 64, 1200
    x = np.full((A, B, n), codeword, np.int32)
    x_hat = _decisions(x, 12 + codeword, 0.003)
    x_hat[3] = codeword                       # a member with no error
    fake = types.SimpleNamespace(
        cfg=types.SimpleNamespace(batch=B, codeword=codeword, channel="bec"),
        G=A, n_var=n, mod=types.SimpleNamespace(send=lambda key, x, p: x),
        dec=types.SimpleNamespace(decode_tables=lambda t, y: (
            jnp.asarray(x_hat), None)))
    want = np.asarray(jax_ens.EnsembleMonteCarloRunner._chunk_body(
        fake, jax.random.PRNGKey(0), 1, 0.4, None))
    got = chunk_kernel.tally(torch.from_numpy(x_hat), codeword)
    assert got.shape == (2, A)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 3] == 0 and (got[0] > 0).sum() == A - 1


def test_runner_chunk_random_codeword_equals_jax(monkeypatch):
    """A whole runner chunk with codeword -1 (the codebook rows drawn
    before the noise) against the JAX runner on the same rows and noise:
    Hamming(7,4), biAWGN min-sum bf16."""
    B, snr = 256, 2.5
    _, idx, _ = _codewords(HAMMING, -1, B, 13)
    noise = _draw("biawgn", (B, 7), 14)
    _inject(monkeypatch, "biawgn", noise)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(idx))
    monkeypatch.setattr(torch, "randint",
                        lambda *a, **kw: torch.from_numpy(idx.copy()))
    common = dict(channel="biawgn", code=HAMMING, decoder="MSA",
                  codeword=-1, batch=B, msg_dtype="bfloat16")
    jr = jax_runner.MonteCarloRunner(jax_runner.RunConfig(**common))
    want = np.asarray(jr._chunk_body(jax.random.PRNGKey(0), 1, snr))
    pr = MonteCarloRunner(RunConfig(device="cpu", **common))
    got = pr._chunk(snr, None).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] > 0


def test_cpu_route_loads_no_kernel_library(monkeypatch):
    """On CPU tensors C1 and C2 run their plain versions: nothing is
    built or loaded, and no launch is counted."""
    def refuse(name):
        raise AssertionError(f"the CPU route loaded {name}")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(chunk_kernel, "load_library", refuse)
    before = (chunk_kernel.transmit_cuda.launches,
              chunk_kernel.tally_cuda.launches)
    for channel in ("biawgn", "bsc", "bec"):
        cfg = RunConfig(channel=channel, code=HAMMING, decoder="ADMM",
                        codeword=-1, batch=64, max_iter=20, device="cpu")
        tally = MonteCarloRunner(cfg)._chunk(PARAMS[channel],
                                             torch.Generator())
        assert tally.shape == (2 + chunk_kernel.HIST_LEN,)
        assert int(tally[2:].sum()) == 64
    assert (chunk_kernel.transmit_cuda.launches,
            chunk_kernel.tally_cuda.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """C1's and C2's wrappers take CUDA tensors only: a CPU tensor raises
    before any kernel is built (the routes send CPU tensors to the plain
    versions)."""
    noise = torch.zeros((4, 8))
    x_hat = torch.zeros((4, 8), dtype=torch.int32)
    calls = [
        lambda: chunk_kernel.transmit_cuda("biawgn", noise, 2.0),
        lambda: chunk_kernel.transmit_cuda("bec", noise, 0.3, want="sym"),
        lambda: chunk_kernel.tally_cuda(x_hat),
        lambda: chunk_kernel.tally_cuda(x_hat[None], all_wrong=True),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("bad", ["raw_2d", "raw_and_all_wrong", "hist_3d",
                                 "want", "codeword", "out_both"])
def test_arguments_refused(bad):
    x_hat = torch.zeros((2, 4, 8), dtype=torch.int32)
    noise = torch.zeros((4, 8))
    calls = {
        "raw_2d": lambda: chunk_kernel.tally(x_hat[0], raw=x_hat[0]),
        "raw_and_all_wrong": lambda: chunk_kernel.tally(
            x_hat, raw=x_hat[0], all_wrong=True),
        "hist_3d": lambda: chunk_kernel.tally(
            x_hat, iters=torch.zeros(4, dtype=torch.int32)),
        "want": lambda: chunk_kernel.transmit("bsc", noise, 0.1, want="x"),
        "codeword": lambda: chunk_kernel.transmit("bsc", noise, 0.1, 2),
        "out_both": lambda: chunk_kernel.transmit(
            "bsc", noise, 0.1, want="both", out=torch.empty(4, 8)),
    }
    with pytest.raises(ValueError):
        calls[bad]()


def test_kernel_source_builds_from_the_repo():
    """C1 and C2 are one source of ``csrc/``, built at first use like the
    others, and named in the build's hash."""
    assert _build.source_files("chunk") == ["chunk.cu"]
    assert _build.library_path("chunk").startswith(_build.BUILD_DIR)
