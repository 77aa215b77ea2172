"""PyTorch port: the LT fountain path against the JAX package.

- ``ideal_soliton``, ``robust_tau``, ``robust_soliton_parts``,
  ``robust_soliton``, ``default_e_pad`` and ``sample_edges`` (light and
  full) equal the JAX functions exactly; ``sample_batch`` makes the same
  draws; the card's edge layout (``ops/lt_kernel.py:edge_layout``) equals
  the host one of ``sample_edges(light=False)``;
- the plain sparse engine equals the JAX sparse engine on the same tables
  in ``result``, ``resolved`` and ``est`` where resolved, failing sims
  included; the dense engine equals the sparse one; ``seg_iters`` changes
  nothing; recovered bits are the message's;
- ``stream_batches``: count, determinism, and nothing sampled for
  ``count <= 0``;
- the CLI: the same file name and ``arr`` as the JAX CLI on the same argv,
  fresh and resumed; ``--mesh`` refused where the batch does not divide
  over its ranks;
- ``viz.luby_graph``: the histogram, soliton and average-degree plots render
  from the port's own Saver file.

All on the CPU at small k and n (the JAX side on its CPU backend, as
tests/test_lt.py runs it). The kernel against the plain version is in
tests/test_torch_cuda.py.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from ldpc_decoders_tpu.fountain import lt as jax_lt  # noqa: E402
from ldpc_decoders_tpu_torch.fountain import lt  # noqa: E402
from ldpc_decoders_tpu_torch.ops import lt_kernel  # noqa: E402

ENGINE_CASES = [(0, 60, 120), (1, 60, 120), (2, 40, 46)]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("k,c,delta", [(100, 0.1, 0.5), (1000, 0.03, 0.5),
                                       (10000, 0.01, 0.5), (37, 0.2, 0.1)])
def test_soliton_functions_equal_jax(k, c, delta):
    assert np.array_equal(lt.ideal_soliton(k), jax_lt.ideal_soliton(k))
    assert np.array_equal(lt.robust_tau(k, c, delta),
                          jax_lt.robust_tau(k, c, delta))
    for a, b in zip(lt.robust_soliton_parts(k, c, delta),
                    jax_lt.robust_soliton_parts(k, c, delta)):
        assert np.array_equal(a, b)
    omega = lt.robust_soliton(k, c, delta)
    assert np.array_equal(omega, jax_lt.robust_soliton(k, c, delta))
    assert lt.default_e_pad(omega, 2 * k) == jax_lt.default_e_pad(omega, 2 * k)


@pytest.mark.parametrize("light", [True, False])
def test_sample_edges_equal_jax(light):
    k, n = 80, 150
    omega = lt.robust_soliton(k, 0.1, 0.5)
    e_pad = lt.default_e_pad(omega, n)
    ours_rng, jax_rng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        ours = lt.sample_edges(ours_rng, omega, k, n, e_pad, light=light)
        ref = jax_lt.sample_edges(jax_rng, omega, k, n, e_pad, light=light)
        assert list(ours) == list(ref)
        for key in ref:
            assert ours[key].dtype == ref[key].dtype
            assert np.array_equal(ours[key], ref[key]), key


def test_sample_batch_and_edge_layout_equal_jax():
    """The port ships the light lists and the JAX sparse engine the full
    tables, from the same draws; the layout built from the light lists
    (on the card in the port, here on the CPU) equals the host tables."""
    k, n = 60, 120
    sim = lt.LTSimulator(k, n, 0.1, 0.5, device="cpu")
    ours = sim.sample_batch(np.random.default_rng(4), 6)
    ref = jax_lt.LTSimulator(k, n, 0.1, 0.5, engine="sparse").sample_batch(
        np.random.default_rng(4), 6)
    for key in ("edge_sym", "edge_var", "msg"):
        assert ours[key].dtype == torch.int32
        assert np.array_equal(ours[key].numpy(), np.asarray(ref[key])), key
    ip_s, perm_var, ip_v = lt_kernel.edge_layout(ours["edge_sym"],
                                                 ours["edge_var"], n, k)
    assert np.array_equal(ip_s.numpy(), np.asarray(ref["indptr_sym"]))
    assert np.array_equal(perm_var.numpy(), np.asarray(ref["perm_var"]))
    assert np.array_equal(ip_v.numpy(), np.asarray(ref["indptr_var"]))


@pytest.mark.parametrize("seed,k,n", ENGINE_CASES)
def test_plain_sparse_engine_equals_jax_sparse(seed, k, n):
    jsim = jax_lt.LTSimulator(k, n, c=0.1, delta=0.5, seg_iters=17,
                              engine="sparse")
    tables = jsim.sample_batch(np.random.default_rng(seed), batch=24)
    res_j, est_j, rsl_j = map(np.asarray, jsim.simulate(tables))
    sim = lt.LTSimulator(k, n, c=0.1, delta=0.5, engine="sparse",
                         device="cpu")
    res, est, rsl = map(_np, sim.simulate(tables))
    assert res.dtype == np.int32 and est.dtype == np.int32
    assert rsl.dtype == bool and rsl.shape == (24, k)
    np.testing.assert_array_equal(res, res_j)
    np.testing.assert_array_equal(rsl, rsl_j)
    np.testing.assert_array_equal(est[rsl], est_j[rsl_j])
    if n == 46:
        assert (res == n).any() and (res < n).any()
    else:
        assert (res < n).all()


@pytest.mark.parametrize("seed,k,n", ENGINE_CASES)
def test_dense_engine_equals_sparse(seed, k, n):
    sparse = lt.LTSimulator(k, n, 0.1, 0.5, engine="sparse", device="cpu")
    dense = lt.LTSimulator(k, n, 0.1, 0.5, engine="dense", device="cpu")
    tables = sparse.sample_batch(np.random.default_rng(seed), 24)
    res_s, est_s, rsl_s = map(_np, sparse.simulate(tables))
    res_d, est_d, rsl_d = map(_np, dense.simulate(tables))
    np.testing.assert_array_equal(res_d, res_s)
    np.testing.assert_array_equal(rsl_d, rsl_s)
    np.testing.assert_array_equal(est_d[rsl_d], est_s[rsl_s])
    # The auto engine on the CPU is the plain sparse peel.
    auto = lt.LTSimulator(k, n, 0.1, 0.5, device="cpu")
    assert auto.engine == "sparse"
    np.testing.assert_array_equal(auto.run(np.random.default_rng(seed), 24)[0],
                                  res_s)


@pytest.mark.parametrize("engine", ["sparse", "dense"])
def test_seg_iters_changes_nothing(engine):
    k, n = 40, 46
    outs = []
    for seg in (1, 5, 64):
        sim = lt.LTSimulator(k, n, 0.1, 0.5, seg_iters=seg, engine=engine,
                             device="cpu")
        outs.append([_np(x) for x in
                     sim.simulate(sim.sample_batch(np.random.default_rng(2),
                                                   16))])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)


def test_recovered_bits_are_the_message():
    k, n = 40, 100
    sim = lt.LTSimulator(k, n, 0.1, 0.5, device="cpu")
    tables = sim.sample_batch(np.random.default_rng(3), 8)
    _, est, rsl = map(_np, sim.simulate(tables))
    msg = tables["msg"].numpy()
    assert rsl.any()
    np.testing.assert_array_equal(est[rsl], msg[rsl])


def test_kernel_route_refuses_cpu_tensors():
    """No fallback: the kernel's wrapper takes CUDA tensors only, and the
    route sends CPU tensors to the plain version."""
    sim = lt.LTSimulator(40, 90, 0.1, 0.5, device="cpu")
    t = sim.sample_batch(np.random.default_rng(1), 2)
    args = (t["edge_sym"], t["edge_var"], t["msg"], 90)
    with pytest.raises(ValueError, match="CUDA"):
        lt_kernel.lt_peel_cuda(*args)
    before = lt_kernel.lt_peel_cuda.launches
    lt_kernel.lt_peel(*args)
    assert lt_kernel.lt_peel_cuda.launches == before
    with pytest.raises(ValueError):
        lt_kernel.lt_peel(t["edge_sym"].long(), *args[1:])


def _shuffle_within_symbols(edge_sym, edge_var, seed):
    """``edge_var`` with each symbol's edges in a seeded random order
    (``edge_sym`` non-decreasing, so a symbol's edges are one range)."""
    rng = np.random.default_rng(seed)
    es, ev = edge_sym.numpy(), edge_var.numpy().copy()
    for b in range(es.shape[0]):
        bounds = np.flatnonzero(np.diff(es[b])) + 1
        for lo, hi in zip(np.r_[0, bounds], np.r_[bounds, es.shape[1]]):
            rng.shuffle(ev[b, lo:hi])
    return torch.from_numpy(ev)


@pytest.mark.parametrize("seed,k,n", ENGINE_CASES)
def test_plain_peel_ignores_edge_order_within_symbols(seed, k, n):
    """Confluence, which the kernel's counting sort relies on (its scatter
    leaves each variable's edges in any order): shuffling each symbol's
    edges reorders every variable's range, and changes no result."""
    sim = lt.LTSimulator(k, n, 0.1, 0.5, device="cpu")
    t = sim.sample_batch(np.random.default_rng(seed), 24)
    shuffled = _shuffle_within_symbols(t["edge_sym"], t["edge_var"],
                                       100 + seed)
    assert not torch.equal(shuffled, t["edge_var"])
    res, est, rsl, _ = lt_kernel.lt_peel_plain(t["edge_sym"], t["edge_var"],
                                               t["msg"], n)
    res2, est2, rsl2, _ = lt_kernel.lt_peel_plain(t["edge_sym"], shuffled,
                                                  t["msg"], n)
    assert torch.equal(res2, res) and torch.equal(rsl2, rsl)
    assert torch.equal(est2[rsl2], est[rsl])


def _pr9_largest_n(k):
    """The largest n at k that the first form of the kernel took:
    8n + 8 ceil(k / 32) bytes of shared memory, and 16-bit symbol ids."""
    return min(lt_kernel.MAX_SYMBOLS,
               (lt_kernel.SMEM_PER_CTA - 8 * ((k + 31) // 32)) // 8)


@pytest.mark.parametrize("k", [32, 10000, 100000, 900000])
def test_kernel_size_checks_keep_every_earlier_size(k):
    """The wrapper's checks, on CPU tensors (no launch): every (k, n) the
    first form of the kernel took is still taken; the kernel's own budget
    (its smallest layout in shared memory, 16-bit symbol ids) is exact,
    and one step past it raises ValueError; the offsets and symbol words
    move to device memory exactly where they no longer fit beside it."""
    z = torch.zeros((1, 8), dtype=torch.int32)
    msg = torch.zeros((1, k), dtype=torch.int32)

    def plan(n):
        return lt_kernel.kernel_plan(z, z, msg, n)

    old = _pr9_largest_n(k)
    plan(old)
    last = max(n for n in range(old, lt_kernel.MAX_SYMBOLS + 1)
               if lt_kernel.shared_bytes(n, k, False)
               <= lt_kernel.SMEM_PER_CTA) if old >= 1 else 0
    assert last >= old
    plan(last)
    with pytest.raises(ValueError, match="16-bit|shared memory"):
        plan(last + 1)
    on_chip = [n for n in range(1, last + 1)
               if lt_kernel.shared_bytes(n, k, True) <= lt_kernel.SMEM_PER_CTA]
    if on_chip:
        assert plan(on_chip[-1]) is True
    if not on_chip or on_chip[-1] < last:
        assert plan(last) is False


def test_kernel_plan_at_the_golden_configuration():
    z = torch.zeros((1, 8), dtype=torch.int32)
    assert lt_kernel.kernel_plan(z, z, torch.zeros((1, 10000),
                                                   dtype=torch.int32), 12000)
    msg = torch.zeros((1, 10000), dtype=torch.int32)
    assert not lt_kernel.kernel_plan(z, z, msg, _pr9_largest_n(10000))
    assert lt_kernel.shared_bytes(12000, 10000, True) == 178540


def _counting_sort_layout(edge_sym, edge_var, n, k, seed):
    """What the kernel's layout gives, in numpy: the offsets, and each
    variable's symbols in a seeded random order, the pads after them."""
    rng = np.random.default_rng(seed)
    B, E = edge_sym.shape
    ip_s = np.zeros((B, n + 2), np.int32)
    ip_v = np.zeros((B, k + 2), np.int32)
    sbv = np.full((B, E), n, np.int32)
    for b in range(B):
        s, v = edge_sym[b].numpy(), edge_var[b].numpy()
        real = int((s < n).sum())
        ip_s[b, :n + 1] = np.searchsorted(s, np.arange(n + 1))
        ip_s[b, n + 1] = E
        cur = np.cumsum(np.bincount(v[:real], minlength=k + 1))
        for e in rng.permutation(real):
            cur[v[e]] -= 1
            sbv[b, cur[v[e]]] = s[e]
        ip_v[b, :k + 1] = cur
        ip_v[b, k + 1] = E
    return tuple(torch.from_numpy(x) for x in (ip_s, sbv, ip_v))


@pytest.mark.parametrize("seed,k,n", ENGINE_CASES)
def test_layout_check_takes_any_order_within_a_variable(seed, k, n):
    """``layout_matches``, the check that holds the kernel's tables to
    ``edge_layout`` on the card: a counting sort in any order within each
    variable passes; one symbol moved to another variable's range, or an
    offset off by one, does not."""
    sim = lt.LTSimulator(k, n, 0.1, 0.5, device="cpu")
    t = sim.sample_batch(np.random.default_rng(seed), 6)
    es, ev = t["edge_sym"], t["edge_var"]
    ip_s, sbv, ip_v = _counting_sort_layout(es, ev, n, k, seed)
    assert lt_kernel.layout_matches((ip_s, sbv, ip_v), es, ev, n)
    moved = sbv.clone()
    j = int(ip_v[0, 1])          # the first edge of variable 1's range
    moved[0, j] = (moved[0, j] + 1) % n
    assert not lt_kernel.layout_matches((ip_s, moved, ip_v), es, ev, n)
    off = ip_v.clone()
    off[0, 2] += 1
    assert not lt_kernel.layout_matches((ip_s, sbv, off), es, ev, n)


def test_stream_batches_counts_and_determinism():
    k, n = 40, 90
    sim = lt.LTSimulator(k, n, c=0.1, delta=0.5, device="cpu")
    got = [r for res in lt.stream_batches(sim, np.random.default_rng(9),
                                          count=20, batch=8)
           for r in res]
    assert len(got) == 20
    rng = np.random.default_rng(9)
    direct = []
    for b in (8, 8, 4):
        res, _, _ = sim.simulate(sim.sample_batch(rng, b))
        direct.extend(int(r) for r in _np(res))
    np.testing.assert_array_equal(got, direct)
    # The JAX package's stream on the same seed gives the same sims.
    jsim = jax_lt.LTSimulator(k, n, c=0.1, delta=0.5, engine="sparse")
    ref = [r for res in jax_lt.stream_batches(jsim, np.random.default_rng(9),
                                              count=20, batch=8)
           for r in res]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("count", [0, -3])
def test_stream_batches_without_sims_samples_nothing(count):
    sim = lt.LTSimulator(40, 90, 0.1, 0.5, device="cpu")
    calls = []
    sim.sample_batch = lambda rng, batch: calls.append(batch)
    assert list(lt.stream_batches(sim, np.random.default_rng(0), count,
                                  8)) == []
    assert calls == []


def _luby_arr(tmp_path, main, argv):
    main(argv + ["--data_dir", str(tmp_path)])
    files = sorted(os.listdir(tmp_path))
    assert files == ["luby-60-120-0.1-0.5.json"], files
    with open(tmp_path / files[0]) as fp:
        return json.load(fp)


def test_cli_equals_jax_cli_fresh_and_resumed(tmp_path):
    argv = ["60", "120", "0.1", "0.5", "20", "--batch", "8", "--seed", "3"]
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    ours = _luby_arr(ours_dir, lt.main, argv + ["--device", "cpu"])
    ref = _luby_arr(ref_dir, jax_lt.main, argv)
    assert ours == ref
    assert list(ours) == ["type", "k", "n", "c", "delta", "arr"]
    assert len(ours["arr"]) == 20
    fresh = ours["arr"]
    argv[4] = "30"
    ours = _luby_arr(ours_dir, lt.main, argv + ["--device", "cpu"])
    ref = _luby_arr(ref_dir, jax_lt.main, argv)
    assert ours == ref and len(ours["arr"]) == 30
    assert ours["arr"][:20] == fresh


def test_cli_refuses_mesh(tmp_path, capsys):
    """A batch that does not divide over the ranks is refused before any
    rank starts or any file is written (the JAX CLI runs it unsharded)."""
    with pytest.raises(SystemExit):
        lt.main(["60", "120", "0.1", "0.5", "8", "--mesh", "3", "--device",
                 "cpu", "--data_dir", str(tmp_path)])
    assert "does not divide over 3 ranks" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_luby_plots_render_from_port_saver_file(tmp_path):
    pytest.importorskip("matplotlib")
    from ldpc_decoders_tpu_torch.viz import luby_graph

    data_dir = tmp_path / "data"
    lt.main(["40", "90", "0.1", "0.5", "8", "--batch", "8", "--device", "cpu",
             "--data_dir", str(data_dir)])
    plots = tmp_path / "plots"
    plots.mkdir()
    luby_graph.main(["hist", "0.1", "0.03", "--data_dir", str(data_dir),
                     "--plots_dir", str(plots), "--agg"])
    assert os.listdir(plots) == ["luby_0.1.png"]
    s_out, a_out = tmp_path / "soliton.png", tmp_path / "avg_deg.png"
    luby_graph.main(["soliton", "1000", "0.03", "0.5", "--agg", "--out",
                     str(s_out)])
    luby_graph.main(["avg_deg", "500", "0.5", "--agg", "--out", str(a_out)])
    assert s_out.stat().st_size > 0 and a_out.stat().st_size > 0


def test_jax_tables_feed_the_port():
    """``simulate`` takes the JAX package's device arrays as they are."""
    jsim = jax_lt.LTSimulator(40, 90, 0.1, 0.5, engine="sparse")
    tables = jsim.sample_batch(np.random.default_rng(6), 4)
    assert isinstance(tables["msg"], jnp.ndarray)
    res, _, _ = lt.LTSimulator(40, 90, 0.1, 0.5, device="cpu").simulate(tables)
    np.testing.assert_array_equal(_np(res), np.asarray(jsim.simulate(tables)[0]))
