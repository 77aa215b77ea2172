"""PyTorch port: the biAWGN channel against the JAX package.

``llr`` and ``send`` (with the same noise injected into both packages)
must match bit for bit; the port's own generator draw must have the
channel's mean and variance."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ldpc_decoders_tpu.channels import biawgn as jax_biawgn  # noqa: E402
from ldpc_decoders_tpu_torch.channels import biawgn  # noqa: E402

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
