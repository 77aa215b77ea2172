"""PyTorch port: the biAWGN and BSC channels against the JAX package.

biAWGN ``llr`` and ``send`` (with the same noise injected into both
packages) must match bit for bit; the port's own generator draw must have
the channel's mean and variance. BSC ``llr`` is within 1 ulp of JAX's
(``log1p`` and ``log`` of p may differ in the last bit between XLA-CPU and
torch-CPU); ``send`` must flip bits at rate p."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ldpc_decoders_tpu.channels import biawgn as jax_biawgn  # noqa: E402
from ldpc_decoders_tpu.channels import bsc as jax_bsc  # noqa: E402
from ldpc_decoders_tpu_torch.channels import CHANNELS, biawgn, bsc  # noqa: E402

SNRS = [0.5, 1.5, 2.0, 2.5, 3.0, 4.0]


@pytest.mark.parametrize("snr", SNRS)
def test_llr_bit_equal(snr):
    y = np.random.default_rng(1).standard_normal((64, 1200)).astype(np.float32)
    want = np.asarray(jax_biawgn.llr(jnp.asarray(y), snr))
    got = biawgn.llr(torch.from_numpy(y), snr).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("snr", [1.5, 3.0])
def test_send_injected_noise_bit_equal(snr, monkeypatch):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2, size=(64, 1200)).astype(np.int32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(torch, "randn",
                        lambda *a, **kw: torch.from_numpy(noise.copy()))
    want = np.asarray(jax_biawgn.send(jax.random.PRNGKey(0),
                                      jnp.asarray(x), snr))
    got = biawgn.send(torch.from_numpy(x), snr, None).numpy()
    np.testing.assert_array_equal(got, want)


def test_send_generator_moments():
    snr, B, n = 2.0, 512, 1200
    gen = torch.Generator().manual_seed(0)
    y = biawgn.send(torch.ones((B, n), dtype=torch.int32), snr, gen).double()
    var = biawgn.noise_var(snr)
    N = B * n
    # Mean +1 within 5 standard errors; sample variance within 5 SE
    # (Var(s^2) = 2 sigma^4 / N for Gaussian noise).
    assert abs(float(y.mean()) - 1.0) < 5 * np.sqrt(var / N)
    assert abs(float(y.var()) - var) < 5 * var * np.sqrt(2.0 / N)
    # Same seed, same draw; another seed, another draw.
    y2 = biawgn.send(torch.ones((B, n), dtype=torch.int32), snr,
                     torch.Generator().manual_seed(0)).double()
    y3 = biawgn.send(torch.ones((B, n), dtype=torch.int32), snr,
                     torch.Generator().manual_seed(1)).double()
    assert torch.equal(y, y2) and not torch.equal(y, y3)


@pytest.mark.parametrize("p", [0.1, 0.06, 0.05, 0.04, 0.02, 0.001])
def test_bsc_llr_within_one_ulp(p):
    y = np.random.default_rng(3).integers(0, 2, size=(64, 1200)).astype(
        np.int32)
    want = np.asarray(jax_bsc.llr(jnp.asarray(y), p))
    got = bsc.llr(torch.from_numpy(y), p).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("p", [0.05, 0.3])
def test_bsc_send_flip_moments(p):
    B, n = 512, 1200
    gen = torch.Generator().manual_seed(0)
    for x0 in (0, 1):
        x = torch.full((B, n), x0, dtype=torch.int32)
        y = bsc.send(x, p, gen)
        assert y.dtype == torch.int32
        assert set(torch.unique(y).tolist()) <= {0, 1}
        rate = float((y != x).double().mean())
        # Flip rate p within 5 standard errors.
        assert abs(rate - p) < 5 * np.sqrt(p * (1 - p) / (B * n)), rate
    y1 = bsc.send(x, p, torch.Generator().manual_seed(1))
    y2 = bsc.send(x, p, torch.Generator().manual_seed(1))
    assert torch.equal(y1, y2) and not torch.equal(y1, y)


def test_channel_registry():
    assert set(CHANNELS) == {"bec", "biawgn", "bsc"}
    for mod in CHANNELS.values():
        assert set(mod.DECODERS) == {"ML", "SPA", "MSA", "LP", "ADMM",
                                     "ADMMA"}
    from ldpc_decoders_tpu_torch.codes import get_code
    code = get_code("7_4_hamming")
    # The JAX defaults: BSC BP checks the syndrome of the received word,
    # biAWGN BP does not; SPA runs the reference inf policy.
    for mod, check_init in ((bsc, True), (biawgn, False)):
        for name in ("SPA", "MSA"):
            dec = mod.DECODERS[name](code, device="cpu").dec
            assert dec.check_init is check_init and dec.variant == name
            assert dec.inf_policy == ("reference" if name == "SPA"
                                      else "saturate")
