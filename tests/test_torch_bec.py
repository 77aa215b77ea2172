"""PyTorch port: the erasure path (BEC channel, ternary erasure SPA) against
the JAX package.

The erasure decoder's dynamics are integer-exact, so the tolerance is
none: symbols and iteration counts equal the JAX gather route
(``BECSPADecoder(perm="gather")``) on regular, irregular and margulis
tables, and the Pallas kernel in interpret mode (``perm="pallas"`` on the
CPU backend) on the regular flagship. The CLI on the CPU writes the JAX
package's Saver file with a WER within |z| <= 4 (Agresti-Coull) of the
committed artifact.
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

from ldpc_decoders_tpu.channels import bec as jax_bec  # noqa: E402
from ldpc_decoders_tpu.codes import get_code as jax_get_code  # noqa: E402
from ldpc_decoders_tpu.decoders.bec_spa import BECSPADecoder as JaxBECSPA  # noqa: E402
from ldpc_decoders_tpu_torch import main as port_main  # noqa: E402
from ldpc_decoders_tpu_torch.channels import CHANNELS, bec  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.decoders.bec_spa import BECSPADecoder  # noqa: E402
from ldpc_decoders_tpu_torch.ops import bec_kernel, geometry  # noqa: E402
from ldpc_decoders_tpu_torch.ops.graph import TannerGraph, bp_tables  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAG = "1200_3_6_ldpc"
IREG = "1200_rho_x5_rand_ldpc_3"


def _erased(n, B, p, seed):
    """Numpy-made channel output of the all-zero word, fed to both
    packages; word 0 has no erasure."""
    y = np.where(np.random.default_rng(seed).random((B, n)) < p, 2,
                 0).astype(np.int32)
    y[0] = 0
    return y


def _port(name, y, max_iter, iter_cap=2000):
    # The port decodes on the JAX graph's own tables (from_jax_graph).
    g = jax_get_code(name).graph
    graph = TannerGraph.from_jax_graph(
        {f.name: np.asarray(getattr(g, f.name))
         for f in dataclasses.fields(g) if f.name != "chk_degrees"})
    dec = BECSPADecoder(graph, max_iter=max_iter, iter_cap=iter_cap)
    x, it = dec.decode(torch.from_numpy(y))
    assert x.dtype == torch.int32 and it.dtype == torch.int32
    return x.numpy(), it.numpy()


def _jax(name, y, max_iter, perm, iter_cap=2000):
    dec = JaxBECSPA(jax_get_code(name).graph, max_iter=max_iter,
                    iter_cap=iter_cap, perm=perm)
    x, it = dec.decode(jnp.asarray(y))
    return np.asarray(x), np.asarray(it)


def _assert_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name,p,max_iter", [
    ("7_4_hamming", 0.3, 10),
    (FLAG, 0.3, 3), (FLAG, 0.3, 10), (FLAG, 0.3, 100),
    (FLAG, 0.375, 3), (FLAG, 0.375, 10), (FLAG, 0.375, 100),
    (FLAG, 0.45, 3), (FLAG, 0.45, 10), (FLAG, 0.45, 100),
    (FLAG, 0.375, 0), (FLAG, 0.45, 0),
    (IREG, 0.4, 100), (IREG, 0.45, 0),
    ("margulis", 0.375, 10), ("margulis", 0.425, 0),
])
def test_bec_spa_equals_jax_gather(name, p, max_iter):
    n = get_code(name).get_n()
    y = _erased(n, 64, p, seed=int(p * 1000) + max_iter)
    got = _port(name, y, max_iter)
    _assert_equal(got, _jax(name, y, max_iter, "gather"))
    assert got[1][0] == 0 and (got[0][0] == 0).all()    # erasure-free word
    assert got[1].max() >= min(max_iter, 3) if max_iter else got[1].max() > 10


@pytest.mark.parametrize("p,max_iter", [(0.4, 10), (0.45, 6)])
def test_bec_spa_equals_pallas_interpret(p, max_iter):
    y = _erased(1200, 32, p, seed=7)
    got = _port(FLAG, y, max_iter)
    _assert_equal(got, _jax(FLAG, y, max_iter, "pallas"))
    assert (got[0] == 2).any() and got[1].max() == max_iter


@pytest.mark.parametrize("name", ["7_4_hamming", FLAG, IREG])
def test_bec_spa_random_symbols(name):
    """Uniformly random symbols are no codeword's image: two checks can
    disagree and a marginal can return to 0, so the stop must be the
    literal comparison of the decisions."""
    n = get_code(name).get_n()
    y = np.random.default_rng(21).integers(0, 3, (64, n)).astype(np.int32)
    got = _port(name, y, 50)
    _assert_equal(got, _jax(name, y, 50, "gather"))
    assert set(np.unique(got[0])) <= {0, 1, 2} and got[1].max() > 1


def test_decoder_options_and_routes():
    g = get_code(FLAG).graph
    dec = BECSPADecoder(g, max_iter=0, iter_cap=7)
    assert dec.iter_cap == 7 and dec.id_keys == ["max_iter"]
    assert BECSPADecoder(g, max_iter=5, iter_cap=7).iter_cap == 5
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BECSPADecoder(g, perm="pallas")
    # The CUDA wrapper refuses a CPU tensor rather than running the plain
    # version, and the router sends CPU tensors to the plain one.
    t = bp_tables(g)
    y = torch.from_numpy(_erased(1200, 4, 0.4, seed=1))
    before = (bec_kernel.bec_spa_decode_cuda.launches,
              bec_kernel.bec_spa_decode_cuda.launches_caps)
    with pytest.raises(ValueError, match="CUDA"):
        bec_kernel.bec_spa_decode_cuda(y, t, max_iter=10)
    x, it = bec_kernel.bec_spa_decode(y, t, max_iter=10)
    xp, ip = bec_kernel.bec_spa_decode_plain(y, t, max_iter=10)
    assert torch.equal(x, xp) and torch.equal(it, ip)
    assert before == (bec_kernel.bec_spa_decode_cuda.launches,
                      bec_kernel.bec_spa_decode_cuda.launches_caps)
    with pytest.raises(ValueError, match="route"):
        bec_kernel.bec_spa_decode(y.to("meta"), t, max_iter=10)
    for caps in ((3, 2, 10), (0, 10), (1, 5), (2, 2, 10)):
        with pytest.raises(ValueError, match="caps"):
            bec_kernel.bec_spa_decode(y, t, max_iter=10, caps=caps)


def test_bec_llr_equals_jax():
    y = np.random.default_rng(2).integers(0, 3, (16, 1200)).astype(np.int32)
    want = np.asarray(jax_bec.llr(jnp.asarray(y)))
    got = bec.llr(torch.from_numpy(y)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {-1e8, 0.0, 1e8}


@pytest.mark.parametrize("p", [0.3, 0.45])
def test_bec_send_injected_mask_equals_jax(p, monkeypatch):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2, size=(64, 1200)).astype(np.int32)
    u = rng.random(x.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, prob, shape: jnp.asarray(u < prob))
    monkeypatch.setattr(torch, "rand",
                        lambda *a, **kw: torch.from_numpy(u.copy()))
    want = np.asarray(jax_bec.send(jax.random.PRNGKey(0), jnp.asarray(x), p))
    got = bec.send(torch.from_numpy(x), p, None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.1, 0.375])
def test_bec_send_erasure_rate(p):
    B, n = 512, 1200
    for x0 in (0, 1):
        x = torch.full((B, n), x0, dtype=torch.int32)
        y = bec.send(x, p, torch.Generator().manual_seed(x0))
        assert set(torch.unique(y).tolist()) == {x0, 2}
        rate = float((y == 2).double().mean())
        # Erasure rate p within 4 standard errors.
        assert abs(rate - p) < 4 * np.sqrt(p * (1 - p) / (B * n)), rate
    y2 = bec.send(x, p, torch.Generator().manual_seed(1))
    y3 = bec.send(x, p, torch.Generator().manual_seed(2))
    assert torch.equal(y, y2) and not torch.equal(y, y3)


def test_bec_registry():
    assert CHANNELS["bec"] is bec
    assert set(bec.DECODERS) == {"ML", "SPA", "MSA", "LP", "ADMM", "ADMMA"}
    assert bec.DECODERS["MSA"] is bec.DECODERS["SPA"]   # the reference's alias
    dec = bec.DECODERS["SPA"](get_code("7_4_hamming"), device="cpu",
                              max_iter=4, msg_dtype="float32",
                              inf_policy="reference")
    assert dec.id_keys == ["max_iter"] and dec.dec.iter_cap == 4
    y = torch.tensor([[2, 0, 0, 0, 0, 0, 0], [2, 2, 2, 0, 0, 0, 2]])
    x_hat, aux = dec.decode(y, 0.3)
    assert x_hat[0].tolist() == [0] * 7 and (x_hat[1] == 2).any()
    assert aux["iters"].dtype == torch.int32


def _ac_var(w, t):
    """Agresti-Coull adjusted binomial variance of an observed rate."""
    p = (w * t + 2.0) / (t + 4.0)
    return p * (1.0 - p) / (t + 4.0)


def test_cli_cpu_bec_matches_artifact(tmp_path):
    res = port_main.main([
        "bec", FLAG, "SPA", "--params", "0.375", "--codeword", "0",
        "--min-wec", "100", "--batch", "256", "--device", "cpu", "--console",
        "--data_dir", str(tmp_path)])
    path = tmp_path / "bec-1200_3_6_ldpc-SPA-0-100-10.json"
    saved = json.loads(path.read_text())
    with open(os.path.join(ROOT, "artifacts", "data", path.name)) as fp:
        ref = json.load(fp)
    assert list(saved) == list(ref)               # the JAX Saver schema
    assert res[0.375]["wec"] == saved["wec"]["0.375"] >= 100
    w_o, t_o = saved["wer"]["0.375"], saved["tot"]["0.375"]
    w_r, t_r = ref["wer"]["0.375"], ref["tot"]["0.375"]
    z = (w_o - w_r) / math.sqrt(_ac_var(w_o, t_o) + _ac_var(w_r, t_r))
    assert abs(z) <= 4.0, (w_o, t_o, w_r, t_r, z)


def test_bec_geometry_fits_every_code():
    """The rule's geometry on every code, margulis among them, and
    Hamming(7,4): G warps per word with G in {1, 2, 4, 8}, the CTA's
    threads and shared memory within an H100's limits, at least one word
    resident per SM, and the geometry ``make_geometry`` gives for its G
    and W."""
    names = sorted(f[:-4] for f in os.listdir(os.path.join(ROOT, "data",
                                                           "codes")))
    for name in names + ["7_4_hamming"]:
        g = get_code(name).graph
        dims = (g.n_chk, g.n_var, g.max_chk_deg, g.max_var_deg)
        geo = bec_kernel.bec_geometry(*dims)
        warps = geo.threads // 32
        assert warps in bec_kernel.GROUP_WARPS, (name, geo)
        assert geo.threads * geo.words <= geometry.MAX_THREADS, name
        assert (geo.table_bytes + geo.words * geo.smem_bytes
                <= geometry.SMEM_PER_CTA), (name, geo)
        assert geo.smem_bytes >= 2 * g.n_var + g.max_chk_deg * g.n_chk, name
        assert geometry.resident_words(geo) >= 1, (name, geo)
        assert geo == bec_kernel.make_geometry(*dims, warps, geo.words)


def test_bec_geometry_refusals():
    """What the kernel or the card cannot take raises before a launch."""
    mk = bec_kernel.make_geometry
    with pytest.raises(ValueError, match="check degree"):
        mk(600, 1200, 9, 3, 1, 1)
    with pytest.raises(ValueError, match="variable degree"):
        mk(600, 1200, 6, 127, 1, 1)
    with pytest.raises(ValueError, match="warps per word"):
        mk(600, 1200, 6, 3, 16, 1)
    with pytest.raises(ValueError, match="words per CTA"):
        mk(600, 1200, 6, 3, 1, 33)
    with pytest.raises(ValueError, match="is its CTA"):
        mk(600, 1200, 6, 3, 2, 16)
    with pytest.raises(ValueError, match="shared memory"):
        mk(4000, 8000, 6, 3, 1, 32)
    with pytest.raises(ValueError, match="16-bit"):
        mk(600, 40000, 6, 3, 1, 1)
    with pytest.raises(ValueError, match="check degree"):
        bec_kernel.bec_geometry(600, 1200, 9, 3)
