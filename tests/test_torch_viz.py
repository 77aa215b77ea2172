"""PyTorch port: the plot layer (``viz.graph``, ``viz.cases``,
``viz.polytope``, ``utils.mpl``, the file and label helpers) and
``ops.graph.exclusive_min`` against the JAX package, on the CPU.

``viz.graph.run`` of both packages gets the same argv over the same Saver
files, the repo's committed ``artifacts/data`` and files the port's runner
writes here; the data lists must agree: the same files in the same order,
the same labels, and the same (x, y) pairs handed to the line plots (each
package's ``Plotter.plot_pairs`` is wrapped to record them) or the same
iteration histograms. Both render their PNG. The projections of the
polytope demos equal the JAX package's within 1e-6 (the same sort-free
algorithm in float32, its sums folded in another order)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import matplotlib  # noqa: E402

matplotlib.use("Agg")

from ldpc_decoders_tpu.ops import graph as jax_graph_ops  # noqa: E402
from ldpc_decoders_tpu.ops import projection as jax_projection  # noqa: E402
from ldpc_decoders_tpu.utils import file as jax_file  # noqa: E402
from ldpc_decoders_tpu.viz import cases as jax_cases  # noqa: E402
from ldpc_decoders_tpu.viz import graph as jax_vg  # noqa: E402
from ldpc_decoders_tpu_torch.harness import MonteCarloRunner, RunConfig  # noqa: E402
from ldpc_decoders_tpu_torch.ops.graph import exclusive_min  # noqa: E402
from ldpc_decoders_tpu_torch.utils import file as port_file  # noqa: E402
from ldpc_decoders_tpu_torch.viz import cases, polytope  # noqa: E402
from ldpc_decoders_tpu_torch.viz import graph as vg  # noqa: E402

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts", "data")


def _run_both(argv, data_dir, tmp_path, monkeypatch, hist_param=None):
    """viz.graph.run of both packages on the same argv; asserts the data
    lists agree and both PNGs exist; returns the port's data list."""
    seen = {}
    for name, mod in (("jax", jax_vg), ("port", vg)):
        drawn = []
        orig = mod.Plotter.plot_pairs

        def record(self, pairs, label, style=None, _orig=orig, _d=drawn):
            _d.append((label, style,
                       sorted((float(k), v) for k, v in pairs.items())))
            return _orig(self, pairs, label, style)

        monkeypatch.setattr(mod.Plotter, "plot_pairs", record)
        plots = str(tmp_path / name)
        args = mod.setup_parser().parse_args(
            argv + ["--agg", "--save", "--data_dir", data_dir,
                    "--plots_dir", plots, "--file_name", "fig"])
        dl = mod.run(args)
        hists = ([r.data["dec"][str(hist_param)] for r in dl]
                 if hist_param is not None else None)
        seen[name] = ([(r.file_name, r.get_label()) for r in dl], drawn,
                      hists, args.channel)
        assert os.path.exists(os.path.join(plots, "fig.png"))
        if name == "port":
            port_dl = dl
    assert seen["port"] == seen["jax"]
    assert port_dl
    return port_dl


@pytest.mark.parametrize("argv,n_files", [
    (["--and", "bsc-7_4_hamming", "--error", "wer",
      "--legend_format", "decoder"], 5),
    (["--and", "biawgn-7_4_hamming", "--or_", "SPA", "MSA", "ML"], 3),
    (["--and", "bec", "margulis", "--legend_format", "channel_decoder",
      "--title", "t", "--xlim", ".3", ".5", "--ylim", "1e-6", "1"], 2),
    (["--and", "bec-1200_3_6_rand_ldpc", "SPA", "10.json",
      "--type", "ensemble"], 10),
    (["--and", "bec", "--or_", "1200_3_6_rand_ldpc_", "--type",
      "regex_average", "--group_regex", "1200_3_6_rand_ldpc_[0-9]+-SPA",
      "avg"], 10),
    (["--and", "bsc-1200_rho_x5_rand_ldpc", "100.json", "--or_", "SPA",
      "MSA", "--type", "regex_average",
      "--group_regex", "1200_rho_x5_rand_ldpc_[0-9]+-SPA", "SPA",
      "--group_regex", "1200_rho_x5_rand_ldpc_[0-9]+-MSA", "MSA"], 20),
    (["--and", "7_4_hamming-ADMM", "--type", "avg_iter"], 3),
])
def test_graph_run_equals_jax_on_artifacts(argv, n_files, tmp_path,
                                           monkeypatch):
    dl = _run_both(argv, ART, tmp_path, monkeypatch)
    assert len(dl) == n_files


def test_hist_iter_equals_jax_on_artifacts(tmp_path, monkeypatch):
    dl = _run_both(["--and", "bsc-7_4_hamming-ADMM", "--type", "hist_iter",
                    "--param", "0.1"], ART, tmp_path, monkeypatch,
                   hist_param=0.1)
    assert len(dl) == 1


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """Saver files the port's runner writes on the CPU: ADMM and ADMMA
    (train mode) with their iteration histograms, SPA and MSA."""
    d = str(tmp_path_factory.mktemp("port_results"))
    for dec, extra in (("ADMM", {}), ("SPA", {}), ("MSA", {}),
                       ("ADMMA", dict(train=True, layers=[16],
                                      cache_dir=d + "_cache"))):
        MonteCarloRunner(RunConfig(
            channel="bsc", code="7_4_hamming", decoder=dec,
            params=[0.05, 0.1], codeword=1, min_wec=10, batch=256,
            max_iter=30, data_dir=d, log_freq=1e9, device="cpu",
            **extra)).run()
    return d


@pytest.mark.parametrize("argv,hist_param", [
    (["--and", "bsc", "--legend_format", "decoder"], None),
    (["--or_", "ADMM", "--error", "wer"], None),
    (["--or_", "ADMM", "--type", "avg_iter"], None),
    (["--or_", "ADMM", "--type", "hist_iter", "--param", "0.05"], 0.05),
    (["--and", "bsc", "--type", "ensemble"], None),
    (["--type", "regex_average", "--group_regex", "ADMM", "admm family"],
     None),
])
def test_graph_run_equals_jax_on_port_files(argv, hist_param, port_results,
                                            tmp_path, monkeypatch):
    dl = _run_both(argv, port_results, tmp_path, monkeypatch, hist_param)
    assert {r.data["decoder"] for r in dl} <= {"ADMM", "ADMMA", "SPA", "MSA"}


def test_graph_run_with_no_match_returns_empty(tmp_path):
    args = vg.setup_parser().parse_args(
        ["--and", "no-such-run", "--agg", "--data_dir", ART,
         "--plots_dir", str(tmp_path)])
    assert vg.run(args) == []
    assert not os.listdir(str(tmp_path))


@pytest.mark.parametrize("case", ["HMG", "MAR"])
def test_cases_make_jax_png_names(case, tmp_path):
    made = {}
    for name, mod in (("jax", jax_cases), ("port", cases)):
        plots = str(tmp_path / name)
        mod.main([case, "--data_dir", ART, "--plots_dir", plots])
        made[name] = sorted(os.listdir(plots))
    assert made["port"] == made["jax"]
    want = {"HMG": 6, "MAR": 3}[case]
    assert len(made["port"]) == want
    assert all(n.startswith(case + "__") and n.endswith(".png")
               for n in made["port"])
    assert cases.all_cases.keys() == jax_cases.all_cases.keys()


@pytest.mark.parametrize("dim", [2, 3])
def test_polytope_demo_equals_jax(dim, tmp_path):
    v, z = polytope.demo_points(dim, 200, seed=dim, device="cpu")
    want = np.asarray(jax_projection.project_parity_polytope(jnp.asarray(v)))
    np.testing.assert_allclose(z, want, rtol=0, atol=1e-6)
    out = str(tmp_path / f"pp{dim}.png")
    polytope.main([str(dim), "--points", "30", "--out", out,
                   "--device", "cpu"])
    assert os.path.getsize(out) > 0


def test_file_helpers_equal_jax(tmp_path):
    names = sorted(os.listdir(ART))
    assert port_file.gen_unique_labels(names) == \
        jax_file.gen_unique_labels(names)
    assert port_file.gen_unique_labels([]) == []
    keys = ["x10", "x2", "A1b", "a1a", "7_4_hamming"]
    assert sorted(keys, key=port_file.naturalkey) == \
        sorted(keys, key=jax_file.naturalkey)
    for filt in (["--and", "bsc", "ADMM"], ["--or_", "ML", "LP"],
                 ["--and", "bec", "--or_", "SPA", "ML"], []):
        pa = port_file.bind_filter_args(
            __import__("argparse").ArgumentParser()).parse_args(filt)
        ja = jax_file.bind_filter_args(
            __import__("argparse").ArgumentParser()).parse_args(filt)
        assert port_file.filter_strings(pa, names) == \
            jax_file.filter_strings(ja, names)


@pytest.mark.parametrize("shape", [(1, 4), (5, 6), (3, 7, 3), (4, 1),
                                   (2, 3, 1)])
def test_exclusive_min_equals_jax(shape):
    x = np.random.default_rng(len(shape) + shape[-1]).normal(
        0, 3, shape).astype(np.float32)
    x[..., 0] = x[..., -1]             # a tie between two slots
    got = exclusive_min(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_graph_ops.exclusive_min(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    if shape[-1] == 1:
        assert np.isinf(got).all() and got.shape == x.shape
