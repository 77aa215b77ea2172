"""PyTorch port: sum-product BP (the plain PyTorch version of the CUDA SPA
kernels) against the JAX package, under both inf policies.

On the CPU the port cannot be bit-equal to the JAX package: ``exp``,
``log1p`` and ``log`` differ in the last bit between XLA-CPU and torch-CPU
on a few percent of arguments, so ``phi`` differs there, and SPA
trajectories amplify such ulps at knife edges. The bars are therefore the
ones the JAX package holds its own SPA routes to:

- check-node functions: sentinel classes and signs equal, finite
  magnitudes within rtol 5e-4;
- refmode f32 against the float64 reference-semantics oracle: words 100%,
  bits >= 0.9995 (tests/test_bp_ref_policy.py);
- bf16 against the Pallas kernels' interpreter, and f32 BSC against the
  exact-f32 interpreter and the f32 incidence route: bits >= 0.999, words
  >= 0.99 (tests/test_pallas_bp.py).

On the card, kernel and plain version both call the CUDA math library and
are held bit-equal (tests/test_torch_cuda.py, chip_smoke.py).
"""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ldpc_decoders_tpu.codes import get_code as jax_get_code  # noqa: E402
from ldpc_decoders_tpu.decoders import bp as jax_bp  # noqa: E402
from ldpc_decoders_tpu.ops.pallas_bp import (  # noqa: E402
    slot_tables,
    spa_decode_pallas,
    spa_ref_decode_pallas,
)
from ldpc_decoders_tpu_torch import main as port_main  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.decoders import bp  # noqa: E402
from ldpc_decoders_tpu_torch.ops import geometry, spa_kernel  # noqa: E402
from ldpc_decoders_tpu_torch.ops.graph import bp_tables  # noqa: E402
from tests.ref_semantics_oracle import decode_spa_ref  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 5e-4
PALLAS = {"saturate": spa_decode_pallas, "reference": spa_ref_decode_pallas}


def _awgn_llr(n, B, snr, seed):
    """Numpy-made biAWGN LLRs of the all-zero word (f32)."""
    rng = np.random.default_rng(seed)
    nv = 10.0 ** (-snr / 10.0)
    y = -1.0 + np.sqrt(nv) * rng.standard_normal((B, n))
    return (-2.0 * y / nv).astype(np.float32)


def _bsc_llr(n, B, p, seed):
    """Numpy-made BSC LLRs of the all-zero word (f32)."""
    flips = np.random.default_rng(seed).random((B, n)) < p
    return ((1 - 2 * flips.astype(np.float64))
            * np.log((1 - p) / p)).astype(np.float32)


def _port(name, llr, msg_dtype, policy, max_iter, check_init):
    dec = bp.BPDecoder(get_code(name).graph, "SPA", max_iter=max_iter,
                       msg_dtype=msg_dtype, check_init=check_init,
                       inf_policy=policy)
    x, it = dec.decode(torch.from_numpy(llr))
    assert x.dtype == torch.int32 and it.dtype == torch.int32
    return x.numpy(), it.numpy()


def _bars(got, want, bits_bar, words_bar):
    bits = float((got == want).mean())
    words = float(((got != 0).any(1) == (want != 0).any(1)).mean())
    msg = (f"bits agree {bits:.6f} (bar {bits_bar}), word outcomes agree "
           f"{words:.4f} (bar {words_bar}), wrong bits "
           f"{int((got != want).sum())}/{got.size}")
    assert bits >= bits_bar and words >= words_bar, msg


def _rows(g, seed):
    """Check-layout rows with sentinels, saturated magnitudes, ties and
    signed zeros."""
    rng = np.random.default_rng(seed)
    shape = (8, g.n_chk, g.max_chk_deg)
    rows = (rng.integers(-8, 9, size=shape) * 0.75).astype(np.float32)
    rows[rows == 0] = -0.0
    pick = rng.random(shape)
    rows = np.where(pick < 0.02, 0.0, rows)
    rows = np.where((pick > 0.02) & (pick < 0.06),
                    rng.choice([38.0, -38.5, 45.0, 1e6], size=shape), rows)
    rows = np.where((pick > 0.06) & (pick < 0.09),
                    rng.choice([jax_bp.INF_S, -jax_bp.INF_S], size=shape),
                    rows)
    # Rows where every slot but the first (or every slot) is saturated,
    # so that +-inf outputs occur.
    sat = rng.choice([38.0, -45.0, jax_bp.INF_S, -jax_bp.INF_S], size=shape)
    c = np.arange(g.n_chk)[None, :, None]
    d = np.arange(g.max_chk_deg)[None, None, :]
    rows = np.where((c % 5 == 0) & (d > 0) | (c % 7 == 0), sat, rows)
    rows = np.where(pick > 0.995, jax_bp.NAN_S, rows)
    return rows.astype(np.float32)


def _classes(v):
    """Sentinel class of each element: 0 finite, 1 +inf, 2 -inf, 3 NaN."""
    return np.select([v > jax_bp._NAN_MIN, v > jax_bp._INF_MIN,
                      v < -jax_bp._INF_MIN], [3, 1, 2], 0)


def test_phi_matches_jax():
    x = np.exp(np.random.default_rng(0).uniform(
        np.log(jax_bp.PHI_EPS), np.log(jax_bp.LLR_CLIP), 200000)
    ).astype(np.float32)
    x[:3] = [jax_bp.PHI_EPS, 0.1, jax_bp.LLR_CLIP]
    want = np.asarray(jax_bp.phi(jnp.asarray(x)))
    got = bp.phi(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert bp.PHI_EPS == jax_bp.PHI_EPS and bp.LLR_CLIP == jax_bp.LLR_CLIP
    assert (bp.INF_S, bp.NAN_S, bp._INF_MIN, bp._NAN_MIN) == (
        jax_bp.INF_S, jax_bp.NAN_S, jax_bp._INF_MIN, jax_bp._NAN_MIN)


def _bf16_patterns():
    """All 65,536 bf16 bit patterns, as float32."""
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32)
    return (bits << 16).view(torch.float32)


def test_phi_table_index_maps_bf16_codes():
    """The kernel's table index: each bf16 code 0x2491..0x4218 (every bf16
    number in (PHI_EPS, 38]) to its own entry 1..7560, and every magnitude
    at or below PHI_EPS, once clipped, to entry 0."""
    codes = torch.arange(0x2491, 0x4218 + 1, dtype=torch.int32)
    idx = spa_kernel.phi_table_index((codes << 16).view(torch.float32))
    assert torch.equal(idx, torch.arange(1, spa_kernel.PHI_TAB_SIZE,
                                         dtype=torch.int32))
    assert spa_kernel.PHI_TAB_SIZE == 7561
    x = _bf16_patterns()
    x = x[torch.isfinite(x)]
    cl = x.abs().clamp(bp.PHI_EPS, bp.LLR_CLIP)
    idx = spa_kernel.phi_table_index(cl)
    assert int(idx.min()) == 0 and int(idx.max()) == 7560
    low = x.abs() <= torch.tensor(bp.PHI_EPS, dtype=torch.float32)
    assert int(low.sum()) > 2 * 0x2490 and (idx[low] == 0).all()
    assert (idx[~low] > 0).all()
    tiny = torch.tensor([0.0, -0.0, 1e-45, 1e-30, bp.PHI_EPS, -bp.PHI_EPS])
    assert (spa_kernel.phi_table_index(
        tiny.abs().clamp(bp.PHI_EPS, bp.LLR_CLIP)) == 0).all()
    assert torch.equal(spa_kernel.phi_table_index(
        spa_kernel.phi_table_inputs()),
        torch.arange(spa_kernel.PHI_TAB_SIZE, dtype=torch.int32))


def test_phi_table_read_through_index_equals_phi():
    """A table built by the plain phi, read through the kernel's index,
    equals phi(clip(|p|, PHI_EPS, 38)) bit for bit on every finite bf16
    pattern p; and the table agrees with the JAX package's phi."""
    tab = spa_kernel.phi_table_plain()
    assert tab.shape == (spa_kernel.PHI_TAB_SIZE,) and tab.dtype == \
        torch.float32
    p = _bf16_patterns()
    p = p[torch.isfinite(p)]
    assert p.numel() == 65536 - 2 * 128      # all but the infs and NaNs
    cl = p.abs().clamp(bp.PHI_EPS, bp.LLR_CLIP)
    got = tab[spa_kernel.phi_table_index(cl).long()]
    want = bp.phi(cl)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    x = spa_kernel.phi_table_inputs().numpy()
    np.testing.assert_allclose(tab.numpy(),
                               np.asarray(jax_bp.phi(jnp.asarray(x))),
                               rtol=RTOL)


def _spa_codes():
    """Every code of the repository that the SPA kernel takes."""
    names = sorted(f[:-4] for f in os.listdir(os.path.join(ROOT, "data",
                                                           "codes")))
    return names + ["7_4_hamming"]


def test_spa_geometry_fits_every_code():
    """The rule's thread count is a warp multiple in [32, 1024], the word's
    state fits the shared memory an H100 SM gives one CTA, and no more
    warps run than the check pass needs."""
    for name in _spa_codes():
        g = get_code(name).graph
        C, V, Dc = g.n_chk, g.n_var, g.max_chk_deg
        assert Dc <= spa_kernel.MAX_CHK_DEG, name
        for bf16 in (True, False):
            geo = spa_kernel.spa_geometry(C, V, Dc, bf16)
            assert geo.threads % 32 == 0 and 32 <= geo.threads <= 1024, name
            assert geo.smem_bytes <= geometry.SMEM_PER_CTA, name
            assert geo.smem_bytes >= 4 * (2 * V + Dc * C), name
            assert geo.threads < C + 32, (name, geo)
            assert geo == spa_kernel.make_geometry(C, V, Dc, geo.threads)
    rule = {(n, bf16): spa_kernel.spa_geometry(n_chk, n_var, 6, bf16).threads
            for n, n_chk, n_var in (("flagship", 600, 1200),
                                    ("margulis", 1320, 2640))
            for bf16 in (True, False)}
    assert rule == {("flagship", True): 256, ("flagship", False): 384,
                    ("margulis", True): 384, ("margulis", False): 384}
    assert spa_kernel.spa_geometry(3, 7, 4, True).threads == 32
    for threads in (0, 48, 2048):
        with pytest.raises(ValueError, match="threads per word"):
            spa_kernel.make_geometry(600, 1200, 6, threads)
    with pytest.raises(ValueError, match="check degree"):
        spa_kernel.make_geometry(600, 1200, 9, 256)
    with pytest.raises(ValueError, match="shared memory"):
        spa_kernel.make_geometry(20000, 40000, 6, 256)


def test_launch_geometry_limits():
    """The card's limits that both kernels' rules read: a warp multiple in
    [32, 1024], a word's shared memory within what an SM gives one CTA, the
    words an SM holds by shared memory, and no warp without check rows."""
    assert geometry.make_geometry(1024, geometry.SMEM_PER_CTA) == (
        1024, geometry.SMEM_PER_CTA, 1, 0)
    # Several words per CTA share its threads and shared memory.
    assert geometry.make_geometry(64, 1000, 16, 2000).words == 16
    with pytest.raises(ValueError, match="words per CTA"):
        geometry.make_geometry(32, 1000, 33)
    with pytest.raises(ValueError, match="shared memory"):
        geometry.make_geometry(32, 10000, 23, 3000)
    with pytest.raises(ValueError, match="shared memory"):
        geometry.make_geometry(256, geometry.SMEM_PER_CTA + 1)
    for threads in (0, 16, 48, 1056):
        with pytest.raises(ValueError, match="threads per word"):
            geometry.make_geometry(threads, 1024)
    # LDPC(1200,3,6): 24,000 bytes of SPA state, 33,600 of ADMM state
    assert [geometry.words_per_sm(b) for b in (24000, 33600, 52800)] == \
        [9, 6, 4]
    assert [geometry.row_threads(C, 8) for C in (3, 32, 33, 600)] == \
        [32, 32, 64, 256]


@pytest.mark.parametrize("name", ["1200_3_6_ldpc", "1200_rho_x5_rand_ldpc_1"])
@pytest.mark.parametrize("policy", ["saturate", "reference"])
def test_spa_check_rows_match_jax(name, policy):
    g = get_code(name).graph
    rows = _rows(g, seed=len(name) + len(policy))
    mask = g.chk_mask.numpy()
    if policy == "saturate":
        rows = np.where(np.abs(rows) > 1e5, 3.0, rows).astype(np.float32)
    jfn, pfn = {"saturate": (jax_bp.spa_check_rows, bp.spa_check_rows),
                "reference": (jax_bp.spa_check_rows_ref,
                              bp.spa_check_rows_ref)}[policy]
    want = np.asarray(jfn(jnp.asarray(rows), jnp.asarray(mask)))
    got = pfn(torch.from_numpy(rows), torch.from_numpy(mask)).numpy()
    want, got = np.where(mask, want, 0), np.where(mask, got, 0)
    np.testing.assert_array_equal(_classes(got), _classes(want))
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    fin = _classes(want) == 0
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL)
    if policy == "reference":      # the rows exercise every class
        assert set(np.unique(_classes(want))) == {0, 1, 2, 3}


def test_ref_check_rows_classes():
    """Unit semantics of the sentinel check update: inf iff all
    leave-one-out factors saturated; NaN input poisons the whole row;
    the all-saturated test uses the row's real degree."""
    mask = torch.ones((1, 1, 4), dtype=torch.bool)
    rows = torch.tensor([[[2.0, 50.0, -bp.INF_S, -40.0]]])
    out = bp.spa_check_rows_ref(rows, mask)[0, 0]
    assert out[0] == bp.INF_S                   # two negatives -> +inf
    assert 0 < out[1] < 3                       # sees the finite 2.0
    rows = torch.tensor([[[2.0, bp.NAN_S, 5.0, -3.0]]])
    assert (bp.spa_check_rows_ref(rows, mask) == bp.NAN_S).all()
    rows = torch.tensor([[[2.0, 1.0, 5.0, -3.0]]])
    assert (bp.spa_check_rows_ref(rows, mask).abs() < 10).all()
    # A padded slot is neither a factor nor an output.
    mask = torch.tensor([[[True, True, True, False]]])
    rows = torch.tensor([[[2.0, 50.0, -bp.INF_S, 1.0]]])
    out = bp.spa_check_rows_ref(rows, mask)[0, 0]
    assert out[0] == -bp.INF_S and out[3] == 0
    assert -3 < out[1] < 0


@pytest.mark.parametrize("name,p,cap,B", [
    ("12_3_4_ldpc", 0.06, 50, 512),
    ("1200_rho_x5_rand_ldpc_3", 0.05, 100, 96),
])
def test_ref_policy_matches_oracle(name, p, cap, B):
    """Refmode f32 against the float64 reference-semantics oracle, deep in
    the cascade regime (the JAX package's own bar)."""
    code = get_code(name)
    llr = _bsc_llr(code.get_n(), B, p, seed=3)
    x_oracle = decode_spa_ref(code.parity_mtx, llr.astype(np.float64), cap)
    x, _ = _port(name, llr, torch.float32, "reference", cap, True)
    word = ((x != 0).any(1) == (x_oracle != 0).any(1)).mean()
    bits = (x == x_oracle).mean()
    assert word == 1.0 and bits >= 0.9995, (word, bits)


@pytest.mark.parametrize("snr", [2.0, 3.0])
@pytest.mark.parametrize("policy", ["saturate", "reference"])
def test_spa_bf16_vs_pallas(policy, snr):
    name, B = "1200_3_6_ldpc", 128
    llr = _awgn_llr(1200, B, snr, seed=int(snr * 10) + 1)
    x, _ = _port(name, llr, torch.bfloat16, policy, 10, False)
    a_tab, h_tab = slot_tables(jax_get_code(name).graph)
    xk, _ = PALLAS[policy](a_tab, h_tab, jnp.asarray(llr), max_iter=10,
                           check_init=False, interpret=True)
    _bars(x, np.asarray(xk), 0.999, 0.99)


@pytest.mark.parametrize("policy", ["saturate", "reference"])
def test_spa_f32_bsc_vs_exact_kernel_and_incidence(policy):
    name, B, p = "1200_3_6_ldpc", 128, 0.05
    llr = _bsc_llr(1200, B, p, seed=5)
    x, _ = _port(name, llr, torch.float32, policy, 10, True)
    assert 0 < int((x != 0).any(1).sum()) < B
    a_tab, h_tab = slot_tables(jax_get_code(name).graph)
    xk, _ = PALLAS[policy](a_tab, h_tab, jnp.asarray(llr), max_iter=10,
                           check_init=True, interpret=True, exact_f32=True)
    _bars(x, np.asarray(xk), 0.999, 0.99)
    dec = jax_bp.BPDecoder(jax_get_code(name).graph, "SPA", max_iter=10,
                           msg_dtype=jnp.float32, perm="incidence",
                           inf_policy=policy)
    xi, _ = jax.jit(dec.decode)(jnp.asarray(llr))
    _bars(x, np.asarray(xi), 0.999, 0.99)


def test_cascade_policies_differ():
    """On the cascade input (IREG member 3, BSC p=0.05, cap 100) the two
    policies must decode differently, so the tests above can tell them
    apart: the clean decoder leaves stuck words wrong that the cascade
    zeroes."""
    name = "1200_rho_x5_rand_ldpc_3"
    llr = _bsc_llr(1200, 96, 0.05, seed=3)
    xr, _ = _port(name, llr, torch.float32, "reference", 100, True)
    xs, _ = _port(name, llr, torch.float32, "saturate", 100, True)
    wr, ws = (xr != 0).any(1), (xs != 0).any(1)
    assert int((wr != ws).sum()) >= 1
    assert int(ws.sum()) > int(wr.sum()), (int(ws.sum()), int(wr.sum()))


def test_decoder_policies_and_routes():
    g = get_code("1200_3_6_ldpc").graph
    assert bp.BPDecoder(g).variant == "SPA"
    assert bp.BPDecoder(g).inf_policy == "reference"
    assert bp.BPDecoder(g, "MSA", inf_policy="reference").inf_policy == \
        "saturate"
    with pytest.raises(ValueError, match="inf_policy"):
        bp.BPDecoder(g, "SPA", inf_policy="clip")
    t = bp_tables(g)
    llr = torch.from_numpy(_bsc_llr(1200, 4, 0.05, seed=1))
    kw = dict(max_iter=10, check_init=True, msg_dtype=torch.float32)
    before = dict(spa_kernel.spa_decode_cuda.launches)
    for policy in spa_kernel.INF_POLICIES:
        with pytest.raises(ValueError, match="CUDA"):
            spa_kernel.spa_decode_cuda(llr, t, inf_policy=policy, **kw)
        x, it = spa_kernel.spa_decode(llr, t, inf_policy=policy, **kw)
        xp, ip = spa_kernel.spa_decode_plain(llr, t, inf_policy=policy, **kw)
        assert torch.equal(x, xp) and torch.equal(it, ip)
    assert spa_kernel.spa_decode_cuda.launches == before
    with pytest.raises(ValueError, match="route"):
        spa_kernel.spa_decode(llr.to("meta"), t, inf_policy="reference",
                              **kw)
    with pytest.raises(ValueError, match="inf_policy"):
        spa_kernel.spa_decode(llr, t, inf_policy="clip", **kw)


def test_cli_cpu_bsc_spa_matches_artifact(tmp_path):
    res = port_main.main([
        "bsc", "1200_3_6_ldpc", "SPA", "--params", "0.06", "--codeword",
        "0", "--batch", "256", "--min-wec", "30", "--device", "cpu",
        "--console", "--data_dir", str(tmp_path)])
    saved = json.loads(
        (tmp_path / "bsc-1200_3_6_ldpc-SPA-0-30-10.json").read_text())
    with open(os.path.join(ROOT, "artifacts", "data",
                           "bsc-1200_3_6_ldpc-SPA-0-100-10.json")) as fp:
        ref = json.load(fp)
    assert list(saved) == list(ref)
    assert res[0.06]["wec"] == saved["wec"]["0.06"] >= 30
    w_o, t_o = saved["wer"]["0.06"], saved["tot"]["0.06"]
    w_r, t_r = ref["wer"]["0.06"], ref["tot"]["0.06"]

    def ac_var(w, t):
        q = (w * t + 2.0) / (t + 4.0)
        return q * (1.0 - q) / (t + 4.0)

    z = (w_o - w_r) / math.sqrt(ac_var(w_o, t_o) + ac_var(w_r, t_r))
    assert abs(z) <= 4.0, (w_o, t_o, w_r, t_r, z)
