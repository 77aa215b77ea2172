"""PyTorch port: min-sum BP (the plain PyTorch version of the CUDA kernel)
against the JAX package.

- bf16: decisions and iteration counts bit-equal to BOTH the Pallas kernel
  (``msa_decode_pallas(interpret=True)``) and the bf16 incidence route,
  the bar of tests/test_pallas_bp.py. (The JAX gather route rounds the
  marginal after the subtraction, not before, and is NOT this semantics
  in bf16.)
- f32: the cross-route tie-jitter bar of
  tests/test_decoders_oracle.py::test_bp_f32_routes_tie_jitter_bound
  against the gather route (<= 1% of words with other decisions, <= 3%
  with other iteration counts): the routes sum a variable's marginal in
  different orders.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ldpc_decoders_tpu.codes import get_code as jax_get_code  # noqa: E402
from ldpc_decoders_tpu.decoders import bp as jax_bp  # noqa: E402
from ldpc_decoders_tpu.ops.pallas_bp import msa_decode_pallas, slot_tables  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.decoders import bp  # noqa: E402
from ldpc_decoders_tpu_torch.ops import geometry, msa_kernel  # noqa: E402
from ldpc_decoders_tpu_torch.ops.graph import bp_tables  # noqa: E402


def _awgn_llr(n, B, snr, seed, codeword=0):
    """Numpy-made biAWGN LLRs (f32), fed to both packages."""
    rng = np.random.default_rng(seed)
    nv = 10.0 ** (-snr / 10.0)
    y = (2.0 * codeword - 1.0) + np.sqrt(nv) * rng.standard_normal((B, n))
    return (-2.0 * y / nv).astype(np.float32)


def _port_decode(name, llr, msg_dtype, check_init=False):
    dec = bp.BPDecoder(get_code(name).graph, "MSA", max_iter=10,
                       msg_dtype=msg_dtype, check_init=check_init)
    x, it = dec.decode(torch.from_numpy(llr))
    assert x.dtype == torch.int32 and it.dtype == torch.int32
    return x.numpy(), it.numpy()


def _jax_decode(name, llr, msg_dtype, perm, check_init=False):
    dec = jax_bp.BPDecoder(jax_get_code(name).graph, "MSA", max_iter=10,
                           msg_dtype=msg_dtype, check_init=check_init,
                           perm=perm)
    x, it = jax.jit(dec.decode)(jnp.asarray(llr))
    return np.asarray(x), np.asarray(it)


@pytest.mark.parametrize("name", ["1200_3_6_ldpc", "1200_rho_x5_rand_ldpc_1"])
def test_msa_check_rows_matches_jax(name):
    g = get_code(name).graph
    rng = np.random.default_rng(4)
    # Quantized magnitudes force ties; signed zeros test "p < 0".
    rows = (rng.integers(-6, 7, size=(16, g.n_chk, g.max_chk_deg)) * 0.5
            ).astype(np.float32)
    rows[rows == 0] = -0.0
    mask = g.chk_mask.numpy()
    for dt_np, dt_t in ((jnp.float32, torch.float32),
                        (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax_bp.msa_check_rows(
            jnp.asarray(rows, dt_np), jnp.asarray(mask)).astype(jnp.float32))
        got = bp.msa_check_rows(torch.from_numpy(rows).to(dt_t),
                                torch.from_numpy(mask)).float().numpy()
        np.testing.assert_array_equal(np.where(mask, got, 0),
                                      np.where(mask, want, 0))


@pytest.mark.parametrize("snr", [2.0, 3.0])
def test_msa_bf16_bit_equal_pallas_and_incidence(snr):
    name, B = "1200_3_6_ldpc", 128
    llr = _awgn_llr(1200, B, snr, seed=int(snr * 10))
    xp, ip = _port_decode(name, llr, torch.bfloat16)

    a_tab, h_tab = slot_tables(jax_get_code(name).graph)
    xk, ik = msa_decode_pallas(a_tab, h_tab, jnp.asarray(llr), max_iter=10,
                               check_init=False, interpret=True)
    np.testing.assert_array_equal(xp, np.asarray(xk))
    np.testing.assert_array_equal(ip, np.asarray(ik))

    xi, ii = _jax_decode(name, llr, jnp.bfloat16, "incidence")
    np.testing.assert_array_equal(xp, xi)
    np.testing.assert_array_equal(ip, ii)
    assert 0 < int(xp.any(axis=1).sum()) < B     # both outcomes occur


def _tie_jitter_bar(a, b, B):
    dec_mism = int((a[0] != b[0]).any(axis=1).sum())
    it_mism = int((a[1] != b[1]).sum())
    assert dec_mism <= 0.01 * B, dec_mism
    assert it_mism <= 0.03 * B, it_mism


def test_msa_f32_bsc_ties_vs_gather():
    name, B, p = "1200_3_6_ldpc", 512, 0.02
    y = (np.random.default_rng(11).random((B, 1200)) < p).astype(np.float32)
    llr = (np.log((1 - p) / p) * (1 - 2 * y)).astype(np.float32)
    port = _port_decode(name, llr, torch.float32, check_init=True)
    ref = _jax_decode(name, llr, jnp.float32, "gather", check_init=True)
    _tie_jitter_bar(port, ref, B)
    assert int(port[0].any(axis=1).sum()) > 0


def test_msa_f32_irregular_vs_gather():
    name, B = "1200_rho_x5_rand_ldpc_1", 256
    llr = _awgn_llr(1200, B, 2.0, seed=9)
    port = _port_decode(name, llr, torch.float32)
    ref = _jax_decode(name, llr, jnp.float32, "gather")
    _tie_jitter_bar(port, ref, B)


def test_msa_check_init_pre_exit():
    llr = np.full((8, 1200), 4.0, np.float32)      # already the zero word
    x, it = _port_decode("1200_3_6_ldpc", llr, torch.bfloat16,
                         check_init=True)
    assert (x == 0).all() and (it == 0).all()
    x, it = _port_decode("1200_3_6_ldpc", llr, torch.bfloat16)
    assert (x == 0).all() and (it == 1).all()     # biAWGN: >= 1 iteration


def test_decoder_refuses_unported():
    g = get_code("1200_3_6_ldpc").graph
    with pytest.raises(ValueError, match="inf_policy"):
        bp.BPDecoder(g, "SPA", inf_policy="clip")
    with pytest.raises(ValueError, match="variant"):
        bp.BPDecoder(g, "ADMM")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bp.BPDecoder(g, "MSA", perm="incidence")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bp.BPDecoder(g, "SPA", perm="pallas")
    with pytest.raises(ValueError, match="caps"):
        bp.BPDecoder(g, "MSA").decode_multi_cap(torch.zeros(1, 1200), (2, 1))
    with pytest.raises(ValueError):
        bp.BPDecoder(g, "MSA", msg_dtype=torch.float16)
    dec = bp.BPDecoder(g, "MSA", msg_dtype="bfloat16", max_iter=0,
                       iter_cap=7)
    assert dec.msg_dtype == torch.bfloat16 and dec.iter_cap == 7


def test_kernel_wrapper_never_falls_back():
    """The CUDA wrapper refuses a CPU tensor rather than running the
    plain version, and the router sends CPU tensors to the plain one."""
    t = bp_tables(get_code("1200_3_6_ldpc").graph)
    llr = torch.from_numpy(_awgn_llr(1200, 4, 3.0, seed=1))
    kw = dict(max_iter=10, check_init=False, msg_dtype=torch.bfloat16)
    before = msa_kernel.msa_decode_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        msa_kernel.msa_decode_cuda(llr, t, **kw)
    x, it = msa_kernel.msa_decode(llr, t, **kw)
    xp, ip = msa_kernel.msa_decode_plain(llr, t, **kw)
    assert torch.equal(x, xp) and torch.equal(it, ip)
    assert msa_kernel.msa_decode_cuda.launches == before
    with pytest.raises(ValueError, match="route"):
        msa_kernel.msa_decode(llr.to("meta"), t, **kw)


def test_kernel_tables_layout():
    """The kernel's slot-major tables index the same edges as the plain
    version's check-layout tables, with -1 on padded slots."""
    g = get_code("1200_rho_x5_rand_ldpc_1").graph
    t = bp_tables(g)
    C, Dc = t.chk_var.shape
    kcv = t.k_chk_var.numpy()
    assert kcv.shape == (Dc, C) and t.k_chk_var.dtype == torch.int32
    np.testing.assert_array_equal(kcv.T, np.where(t.cmask, t.chk_var, -1))
    kvs = t.k_var_slot.numpy().T                    # [V, Dv]
    vs = t.var_slot.numpy()
    np.testing.assert_array_equal(
        kvs, np.where(t.vmask, (vs % Dc) * C + vs // Dc, -1))
    # Every real edge appears exactly once on each side.
    assert (kcv >= 0).sum() == (kvs >= 0).sum() == g.n_edge
    assert len(np.unique(kvs[kvs >= 0])) == g.n_edge


def _bp_codes():
    """Every code of the repository, margulis among them, and Hamming(7,4)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = sorted(f[:-4] for f in os.listdir(os.path.join(root, "data",
                                                           "codes")))
    return names + ["7_4_hamming"]


def test_msa_geometry_fits_every_code():
    """The rule's geometry on every code, in bf16 and f32: G warps per
    word with G in {1, 2, 4, 8}, the CTA's threads and shared memory
    within an H100's limits, at least one word resident per SM, and the
    same geometry as ``make_geometry`` gives for its G and W."""
    for name in _bp_codes():
        g = get_code(name).graph
        dims = (g.n_chk, g.n_var, g.max_chk_deg, g.max_var_deg)
        for bf16 in (True, False):
            geo = msa_kernel.msa_geometry(*dims, bf16)
            warps = geo.threads // 32
            assert warps in msa_kernel.GROUP_WARPS, (name, geo)
            assert geo.threads * geo.words <= geometry.MAX_THREADS, name
            assert (geo.table_bytes + geo.words * geo.smem_bytes
                    <= geometry.SMEM_PER_CTA), (name, geo)
            assert geo.smem_bytes >= (4 * g.n_var + (2 if bf16 else 4)
                                      * g.max_chk_deg * g.n_chk), name
            assert geometry.resident_words(geo) >= 1, (name, geo)
            assert geo == msa_kernel.make_geometry(*dims, bf16, warps,
                                                   geo.words)


def test_msa_geometry_refusals():
    """What the kernel or the card cannot take raises before a launch."""
    mk = msa_kernel.make_geometry
    with pytest.raises(ValueError, match="check degree"):
        mk(600, 1200, 9, 3, True, 1, 1)
    with pytest.raises(ValueError, match="warps per word"):
        mk(600, 1200, 6, 3, True, 3, 1)
    with pytest.raises(ValueError, match="words per CTA"):
        mk(600, 1200, 6, 3, True, 8, 8)
    with pytest.raises(ValueError, match="is its CTA"):
        mk(600, 1200, 6, 3, True, 2, 16)
    with pytest.raises(ValueError, match="shared memory"):
        mk(1320, 2640, 6, 3, False, 1, 6)
    assert mk(1320, 2640, 6, 3, False, 1, 5).words == 5
    with pytest.raises(ValueError, match="check degree"):
        msa_kernel.msa_geometry(600, 1200, 9, 3, True)
