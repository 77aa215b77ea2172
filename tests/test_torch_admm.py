"""PyTorch port: ADMM LP decoding against the JAX package on the CPU.

The same numpy-seeded inputs go through both packages:

- ``project_parity_polytope`` against ``ldpc_decoders_tpu.ops.projection``
  (atol 1e-6: same algorithm, float32, sums folded in another order) and
  against the C++ oracle ``ldpc_decoders_tpu.native`` (atol 2e-4, the JAX
  package's own bar for float32 against the float64 oracle);
- ``admm_decode_plain`` (through ``ADMMDecoder``) against the JAX gather
  route and against ``admm_decode_pallas(interpret=True)``. The routes sum
  in different orders (and the Pallas kernel and the port multiply by 1/mu
  where the gather route divides), so a word can converge one iteration
  apart: the bar is
  the JAX package's own between its two routes
  (``tests/test_pallas_bp.py``): decisions equal on >= 0.999 of bits,
  iteration counts on >= 0.95 of words (BEC, degenerate erasure LPs:
  >= 0.9);
- Hamming(7,4), whose variable degrees are 1, 1, 1, 2, 2, 2, 3, incl.
  ``allow_pseudo`` fractional outputs (atol 1e-5) and the k - 1 / cap
  iteration convention; margulis against the gather route.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ldpc_decoders_tpu import get_code as jax_get_code  # noqa: E402
from ldpc_decoders_tpu import native  # noqa: E402
from ldpc_decoders_tpu.decoders.admm import ADMMDecoder as JaxADMM  # noqa: E402
from ldpc_decoders_tpu.ops import projection as jax_projection  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.decoders.admm import ADMMDecoder  # noqa: E402
from ldpc_decoders_tpu_torch.ops import admm_kernel  # noqa: E402
from ldpc_decoders_tpu_torch.ops.graph import bp_tables  # noqa: E402
from ldpc_decoders_tpu_torch.ops.projection import (  # noqa: E402
    project_check_rows,
    project_parity_polytope,
)
from ldpc_decoders_tpu_torch.utils.math import (  # noqa: E402
    pseudo_to_cw,
    pseudo_to_cw_tensor,
)

SAFE_INF = 1e8
# graph -> threads per word: what the rule settled on.
THREADS_BY_RULE = {
    "1200_3_6_ldpc": 256, "margulis": 512, "7_4_hamming": 32,
    "1200_rho_x5_rand_ldpc_3": 256, "1200_rho_x5_rand_ldpc_1": 256,
    "4_2_test": 32,
}


def _rows(d, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(0, 1, (200, d)),
        rng.normal(0.5, 3, (200, d)),
        rng.normal(0, 30, (50, d)),
    ]).astype(np.float32)


@pytest.mark.parametrize("d", [3, 4, 6, 7])
@pytest.mark.parametrize("masked", [False, True])
def test_projection_equals_jax(d, masked):
    v = _rows(d, seed=d)
    mask = None
    if masked:
        pad = 2
        v = np.concatenate([v, np.zeros((v.shape[0], pad), np.float32)], 1)
        mask = np.concatenate([np.ones((v.shape[0], d), bool),
                               np.zeros((v.shape[0], pad), bool)], axis=1)
    want = np.asarray(jax_projection.project_parity_polytope(
        jnp.asarray(v), mask=None if mask is None else jnp.asarray(mask)))
    got = project_parity_polytope(
        torch.from_numpy(v),
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # a row whose cube-clip lies in the polytope projects to that clip
    easy = (got.numpy()[:, :d] == v[:, :d].clip(0.0, 1.0)).all(axis=1)
    assert 0 < int(easy.sum()) < v.shape[0]      # both branches taken
    if masked:
        assert (got.numpy()[:, d:] == 0.0).all()
        direct = project_parity_polytope(torch.from_numpy(v[:, :d].copy()))
        np.testing.assert_array_equal(got.numpy()[:, :d], direct.numpy())


@pytest.mark.parametrize("d", [3, 4, 6, 7])
def test_projection_matches_native_oracle(d):
    v = _rows(d, seed=10 + d)
    ours = project_parity_polytope(torch.from_numpy(v)).numpy()
    oracle = native.proj_rows(v.astype(np.float64))
    np.testing.assert_allclose(ours, oracle, atol=2e-4)


@pytest.mark.parametrize("row", [
    [0.7, 0.7, 0.7, 0.7],
    [1.2, 1.2, -0.3, -0.3],
    [0.5, 0.5, 0.5],
    [2.0, 2.0, 2.0],
    [-1.0, -1.0, 0.2, 0.2, 0.9],
    [-3.0, -0.1, -7.0, -2.0],          # all negative -> 0
    [2.0, 1.5, 9.0, 1.1],              # all > 1, even length -> all ones
    [2.0, 1.5, 9.0],                   # all > 1, odd length -> a face
])
def test_projection_ties_and_edge_cases(row):
    v = np.float32([row])
    ours = project_parity_polytope(torch.from_numpy(v)).numpy()
    want = np.asarray(jax_projection.project_parity_polytope(jnp.asarray(v)))
    np.testing.assert_allclose(ours, want, atol=1e-6)
    np.testing.assert_allclose(ours, native.proj_rows(v.astype(np.float64)),
                               atol=3e-4)


def test_project_check_rows_mixed_degrees():
    jc, c = jax_get_code("4_2_test"), get_code("4_2_test")  # degrees 2, 3, 2
    v = np.random.default_rng(3).normal(
        0.5, 1.5, (8, c.graph.n_edge)).astype(np.float32)
    want = np.asarray(jax_projection.project_check_rows(jc.graph,
                                                        jnp.asarray(v)))
    got = project_check_rows(c.graph, torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_pseudo_to_cw_twins():
    x = np.float32([0.0, 3e-9, 0.2, 0.5, 0.50001, 1 - 3e-9, 1.0])
    for allow in (False, True):
        want = pseudo_to_cw(x, allow)
        got = pseudo_to_cw_tensor(torch.from_numpy(x), allow).numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    assert pseudo_to_cw_tensor(torch.from_numpy(x), False).dtype == torch.int32


def test_word_sum_is_a_sum():
    rows = torch.from_numpy(np.random.default_rng(0).random(
        (5, 1320)).astype(np.float32))
    got = admm_kernel.word_sum(rows).numpy()
    np.testing.assert_allclose(got, rows.double().sum(dim=1).numpy(),
                               rtol=1e-6)
    # exact on integers, whatever the order
    ints = torch.arange(600, dtype=torch.float32).repeat(3, 1)
    assert admm_kernel.word_sum(ints).tolist() == [179700.0] * 3


def _scalar_word_sum(row):
    """The documented order, one float32 addition at a time: blocks of 8
    consecutive rows halved with strides 4, 2, 1; block b to lane b mod 32,
    a lane adding its blocks in ascending order; the 32 lanes halved with
    strides 16, 8, 4, 2, 1."""
    f32 = np.float32
    n_blk = -(-len(row) // 8)
    blocks = []
    for b in range(n_blk):
        part = [row[8 * b + i] if 8 * b + i < len(row) else f32(0)
                for i in range(8)]
        for s in (4, 2, 1):
            part = [f32(part[i] + part[i + s]) for i in range(s)]
        blocks.append(part[0])
    lanes = []
    for j in range(32):
        acc = blocks[j] if j < n_blk else f32(0)
        for b in range(j + 32, n_blk, 32):
            acc = f32(acc + blocks[b])
        lanes.append(acc)
    for s in (16, 8, 4, 2, 1):
        lanes = [f32(lanes[i] + lanes[i + s]) for i in range(s)]
    return lanes[0]


@pytest.mark.parametrize("n_chk", [3, 600, 1320, 1001])
def test_word_sum_follows_documented_order(n_chk):
    """1001 rows fill neither the last block of 8 nor the last turn of 32
    lanes."""
    rows = np.random.default_rng(n_chk).random((3, n_chk)).astype(np.float32)
    rows[1] *= np.float32(1e-6)                    # the threshold's scale
    got = admm_kernel.word_sum(torch.from_numpy(rows)).numpy()
    want = np.float32([_scalar_word_sum(r) for r in rows])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(THREADS_BY_RULE))
def test_geometry_rule(name):
    g = get_code(name).graph
    C, V, Dc = g.n_chk, g.n_var, g.max_chk_deg
    geo = admm_kernel.admm_geometry(C, V, Dc)
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 1024
    # no warp without a run of 32 rows in the first turn
    assert geo.threads // 32 <= -(-C // 32)
    assert geo.smem_bytes == 4 * (2 * Dc * C + V + 2 * -(-C // 8))
    assert geo.smem_bytes <= 227 * 1024
    assert geo == admm_kernel.make_geometry(C, V, Dc, geo.threads)
    assert geo.threads == THREADS_BY_RULE[name]


def test_geometry_rule_by_state_size():
    """Twice the warps while the words an SM holds by shared memory still
    fit it by warps; never past 1024 threads or the graph's runs of rows."""
    threads = [admm_kernel.admm_geometry(C, 2 * C, 6).threads
               for C in (64, 600, 800, 900, 1320, 2000, 4000)]
    assert threads == [64, 256, 256, 512, 512, 1024, 1024]


def test_geometry_refusals():
    with pytest.raises(ValueError, match="check degree"):
        admm_kernel.admm_geometry(10, 20, admm_kernel.MAX_CHK_DEG + 1)
    with pytest.raises(ValueError, match="shared memory"):
        admm_kernel.admm_geometry(8000, 16000, 6)
    for threads in (0, 48, 1056):
        with pytest.raises(ValueError):
            admm_kernel.make_geometry(600, 1200, 6, threads)


@pytest.mark.parametrize("row,mask_pad", [
    ([2.0, 2.0, 0.5], 0),
    ([3.0, 2.5, 0.25], 0),
    ([2.0, 2.0, 0.5], 3),              # the same row in a padded check
    ([0.5, 2.0, 2.0, -1.0, -2.0], 0),
    ([2.0, 2.0, 0.5, -1.0, -1.0, -3.0], 0),
])
def test_projection_plateau_of_T(row, mask_pad):
    """Rows on which T(beta) equals r at two or more distinct candidates:
    then hi < lo, t_lo - t_hi = 0 and beta is lo itself."""
    v = np.float32(row)
    d = len(row)
    z = v.clip(0, 1)
    r = np.floor(z.sum()) // 2 * 2
    order = np.argsort(-v, kind="stable")
    f = -np.ones(d, np.float32)
    f[order[:int(r) + 1]] = 1.0
    assert f @ z > r                                   # outside the polytope
    cand = np.unique(np.concatenate(
        [np.where(f > 0, v - 1, -v), np.where(f > 0, v, 1 - v), [0.0]]
    ).clip(0, None).astype(np.float32))
    T = np.float32([f @ (v - b * f).clip(0, 1) for b in cand])
    assert (T == r).sum() >= 2
    lo = cand[T >= r].max()
    assert cand[T <= r].min() < lo
    want = (v - lo * f).clip(0, 1)
    vv = np.concatenate([v, np.zeros(mask_pad, np.float32)])[None]
    mask = None
    if mask_pad:
        mask = torch.from_numpy(
            np.concatenate([np.ones(d, bool), np.zeros(mask_pad, bool)])[None])
    got = project_parity_polytope(torch.from_numpy(vv), mask=mask).numpy()[0]
    np.testing.assert_array_equal(got[:d], want)
    assert (got[d:] == 0).all()
    assert want.sum() % 2 == 0 and set(want) <= {0.0, 1.0}  # an even vertex
    jw = np.asarray(jax_projection.project_parity_polytope(
        jnp.asarray(v[None])))[0]
    np.testing.assert_allclose(got[:d], jw, atol=1e-6)


def _llr(channel, param, shape, seed):
    """Channel LLRs of the all-ones codeword, noise from numpy."""
    rng = np.random.default_rng(seed)
    if channel == "biawgn":
        nv = 10.0 ** (-param / 10.0)
        y = 1.0 + np.sqrt(nv) * rng.standard_normal(shape)
        return (-2.0 * y / nv).astype(np.float32)
    if channel == "bsc":
        y = (rng.random(shape) >= param).astype(np.float32)
        return (np.log((1 - param) / param) * (1.0 - 2.0 * y)).astype(
            np.float32)
    y = np.where(rng.random(shape) < param, 2, 1)
    return np.float32([SAFE_INF, -SAFE_INF, 0.0])[y]


def _both(name, llr, **kw):
    jd = JaxADMM(jax_get_code(name).graph, **kw)
    xj, ij = jax.jit(jd.decode)(jnp.asarray(llr))
    pd = ADMMDecoder(get_code(name).graph, device="cpu", **kw)
    xp, ip = pd.decode(torch.from_numpy(llr))
    return np.asarray(xj), np.asarray(ij), xp.numpy(), ip.numpy()


@pytest.mark.parametrize("channel,param,batch,cap,iter_bar", [
    ("biawgn", 3.0, 64, 30, 0.95),
    ("bec", 0.35, 32, 50, 0.9),
])
def test_plain_matches_jax_gather_and_pallas(channel, param, batch, cap,
                                             iter_bar):
    from ldpc_decoders_tpu.ops.pallas_bp import admm_decode_pallas, slot_tables

    name = "1200_3_6_ldpc"
    llr = _llr(channel, param, (batch, 1200), seed=5)
    xj, ij, xp, ip = _both(name, llr, mu=3.0, eps=1e-5, max_iter=cap)
    assert xp.dtype == np.int32 and ip.dtype == np.int32
    assert (xj == xp).mean() >= 0.999
    assert (ij == ip).mean() >= iter_bar
    assert ip.min() < cap                          # some word converged

    graph = jax_get_code(name).graph
    a_tab, _ = slot_tables(graph)
    xk, ik = admm_decode_pallas(a_tab, jnp.asarray(llr), mu=3.0, eps=1e-5,
                                max_iter=cap, n_edge=graph.n_edge, var_deg=3,
                                interpret=True)
    assert (np.asarray(xk) == xp).mean() >= 0.999
    assert (np.asarray(ik) == ip).mean() >= iter_bar


@pytest.mark.parametrize("channel,param", [("bsc", 0.1), ("biawgn", 2.0),
                                           ("bec", 0.3)])
def test_hamming_irregular_variable_degree(channel, param):
    """Hamming(7,4) has variable degrees 1..3: each variable is divided by
    its own degree. Its fractional LP vertices have coordinates at 0.5,
    where the hard decision of a word stopped by the cap hangs on the last
    bit of x: the fractional solutions must agree (atol 1e-5), and the
    decisions wherever x is off that tie."""
    llr = _llr(channel, param, (256, 7), seed=7)
    xj, ij, xp, ip = _both("7_4_hamming", llr, max_iter=50)
    fj, _, fp, _ = _both("7_4_hamming", llr, max_iter=50, allow_pseudo=True)
    np.testing.assert_allclose(fp, fj, atol=1e-5)
    off_tie = np.abs(fj - 0.5) > 1e-4
    assert off_tie.mean() >= 0.9
    np.testing.assert_array_equal(xp[off_tie], xj[off_tie])
    assert (ij == ip).mean() >= 0.95
    assert ((ip >= 0) & (ip <= 50)).all()


def test_hamming_allow_pseudo_and_iteration_convention():
    rng = np.random.default_rng(1)
    gamma = rng.normal(0.0, 1.0, (64, 7)).astype(np.float32)
    xj, ij, xp, ip = _both("7_4_hamming", gamma, max_iter=-1,
                           allow_pseudo=True)
    assert xp.dtype == np.float32
    assert ((xp >= 0) & (xp <= 1)).all()
    np.testing.assert_allclose(xp, xj, atol=1e-5)
    assert (ij == ip).mean() >= 0.95
    frac = (xp > 1e-3) & (xp < 1 - 1e-3)
    assert frac.any()                              # pseudo-codewords stay

    # Codewords decode to themselves well below the cap (k - 1 counts);
    # a cap of 2 stops every word at exactly 2.
    cb = get_code("7_4_hamming").cb
    gamma = (np.log(0.95 / 0.05) * (1.0 - 2.0 * cb)).astype(np.float32)
    _, ij, xp, ip = _both("7_4_hamming", gamma, max_iter=200)
    np.testing.assert_array_equal(xp, cb)
    np.testing.assert_array_equal(ip, ij)
    assert (ip < 200).all()
    _, ij, _, ip = _both("7_4_hamming", gamma, max_iter=2)
    assert (ip == 2).all() and (ij == 2).all()


def test_margulis_matches_gather_route():
    llr = _llr("biawgn", 2.0, (8, 2640), seed=9)
    xj, ij, xp, ip = _both("margulis", llr, max_iter=20)
    assert (xj == xp).mean() >= 0.999
    assert (ij == ip).mean() >= 0.95


def test_router_and_decoder_refusals():
    code = get_code("7_4_hamming")
    t = bp_tables(code.graph)
    llr = torch.zeros((2, 7))
    kw = dict(mu=3.0, eps=1e-5, max_iter=5, n_edge=code.graph.n_edge)
    before = admm_kernel.admm_decode_cuda.launches
    x_hat, iters, x = admm_kernel.admm_decode(llr, t, **kw)   # CPU -> plain
    assert admm_kernel.admm_decode_cuda.launches == before
    assert x_hat.shape == (2, 7) and iters.shape == (2,) and x.shape == (2, 7)
    with pytest.raises(ValueError, match="CUDA"):
        admm_kernel.admm_decode_cuda(llr, t, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP A.4"):
        ADMMDecoder(code.graph, perm="gather")
    assert ADMMDecoder(code.graph, max_iter=0, iter_cap=8000).iter_cap == 8000
    assert ADMMDecoder.id_keys == JaxADMM.id_keys
