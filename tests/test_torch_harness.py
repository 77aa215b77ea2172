"""PyTorch port: the Monte-Carlo slice as a whole against the JAX package.

- one chunk's packed [wec, bec] tally from the same injected noise equals
  the JAX runner's (bf16, where the port is bit-equal to the incidence
  route);
- the CLI on the CPU writes the JAX package's Saver file, with a WER
  within |z| <= 4 (Agresti-Coull, docs/PARITY.md) of the committed
  artifact;
- an ADMM run's Saver file carries the iteration histogram (``dec``:
  ``average`` and a 2000-long ``iter``) in the JAX key order; the CLI's
  ADMM, ML and LP runs on Hamming(7,4) are within |z| <= 4 of their
  goldens; the host-only (LP) chunk returns the same packed tally;
- importing the port pulls in neither jax nor ldpc_decoders_tpu.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ldpc_decoders_tpu.harness import runner as jax_runner  # noqa: E402
from ldpc_decoders_tpu.harness.saver import Saver as JaxSaver  # noqa: E402
from ldpc_decoders_tpu_torch import main as port_main  # noqa: E402
from ldpc_decoders_tpu_torch.harness import MonteCarloRunner, RunConfig, Saver  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "data",
                        "biawgn-1200_3_6_ldpc-MSA-1-100-10.json")


def _ac_var(w, t):
    """Agresti-Coull adjusted binomial variance of an observed rate."""
    p = (w * t + 2.0) / (t + 4.0)
    return p * (1.0 - p) / (t + 4.0)


@pytest.mark.parametrize("snr", [2.0, 2.5])
def test_chunk_tally_equals_jax(snr, monkeypatch):
    B = 128
    noise = np.random.default_rng(int(snr * 10)).standard_normal(
        (B, 1200)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(torch, "randn",
                        lambda *a, **kw: torch.from_numpy(noise.copy()))
    common = dict(channel="biawgn", code="1200_3_6_ldpc", decoder="MSA",
                  codeword=1, batch=B, msg_dtype="bfloat16")
    jr = jax_runner.MonteCarloRunner(jax_runner.RunConfig(**common))
    want = np.asarray(jr._chunk_body(jax.random.PRNGKey(0), 1, snr))
    pr = MonteCarloRunner(RunConfig(device="cpu", **common))
    got = pr._chunk(snr, None).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] > 0


def test_cli_cpu_run_matches_artifact(tmp_path):
    res = port_main.main([
        "biawgn", "1200_3_6_ldpc", "MSA", "--params", "2.0", "--codeword",
        "1", "--min-wec", "50", "--batch", "256", "--bf16", "--device",
        "cpu", "--console", "--data_dir", str(tmp_path)])
    path = tmp_path / "biawgn-1200_3_6_ldpc-MSA-1-50-10.json"
    saved = json.loads(path.read_text())
    with open(ARTIFACT) as fp:
        ref = json.load(fp)
    assert list(saved) == list(ref)               # the JAX Saver schema
    assert saved["wec"]["2.0"] >= 50 and saved["tot"]["2.0"] % 256 == 0
    assert res[2.0]["wec"] == saved["wec"]["2.0"]
    w_o, t_o = saved["wer"]["2.0"], saved["tot"]["2.0"]
    w_r, t_r = ref["wer"]["2.0"], ref["tot"]["2.0"]
    z = (w_o - w_r) / math.sqrt(_ac_var(w_o, t_o) + _ac_var(w_r, t_r))
    assert abs(z) <= 4.0, (w_o, t_o, w_r, t_r, z)


# --kernel is not ported; --mesh and --mesh-code are, and refuse what they
# cannot run: a non-BP or erasure decoder over a code mesh, a batch that does
# not divide, a negative count, NCCL without cards.
_MESH_REFUSALS = {
    "ADMMA --mesh-code": "shards the LLR-domain BP decoders",
    "--mesh 3": "does not divide",
    "--mesh-code -2": "count ranks",
    "--dist-backend nccl": "needs --device cuda",
    "ldpc SPA --mesh-code": "shards the LLR-domain BP decoders",
}


@pytest.mark.parametrize("argv", [
    ["bec", "1200_3_6_ldpc", "ADMMA", "--mesh-code", "4"],
    ["bsc", "1200_3_6_ldpc", "ADMMA", "--train", "--mesh", "3"],
    ["biawgn", "1200_3_6_ldpc", "ADMMA", "--kernel", "pallas"],
    ["biawgn", "1200_3_6_ldpc", "MSA", "--layers", "50", "--mesh-code", "-2"],
    ["biawgn", "1200_3_6_ldpc", "MSA", "--mesh", "2", "--dist-backend",
     "nccl", "--device", "cpu"],
    ["biawgn", "1200_3_6_ldpc", "MSA", "--kernel", "xla"],
    ["bsc", "1200_3_6_ldpc", "ADMM", "--train", "--kernel", "xla"],
    ["bec", "1200_3_6_ldpc", "SPA", "--mesh-code", "2"],
])
def test_cli_refuses_unported(argv, capsys):
    with pytest.raises(SystemExit) as e:
        port_main.parse_args(argv)
    assert e.value.code != 0
    err = capsys.readouterr().err
    line = " ".join(argv)
    want = [m for k, m in _MESH_REFUSALS.items() if k in line]
    if "--kernel" in argv:
        want = ["not ported yet (ROADMAP A.4"]
    assert len(want) == 1 and want[0] in err, (want, err)


def test_cli_flags_map_to_config():
    args = port_main.parse_args([
        "biawgn", "1200_3_6_ldpc", "MSA", "--params", "1.0", "2.0",
        "--max-iter", "5", "--bf16", "--pipeline", "2", "--fixed-pipeline",
        "--max-words", "1000", "--device", "cpu"])
    assert args.params == [1.0, 2.0] and args.max_iter == 5 and args.bf16
    assert args.pipeline == 2 and args.fixed_pipeline
    assert args.max_words == 1000 and args.device == "cpu"
    args = port_main.parse_args(["bsc", "1200_3_6_ldpc", "SPA",
                                 "--inf-policy", "saturate"])
    assert args.inf_policy == "saturate" and not args.bf16
    assert port_main.parse_args(
        ["bsc", "1200_3_6_ldpc", "SPA"]).inf_policy == "reference"
    with pytest.raises(SystemExit):
        port_main.parse_args(["bsc", "1200_3_6_ldpc", "SPA",
                              "--inf-policy", "clip"])
    args = port_main.parse_args([
        "bsc", "margulis", "ADMM", "--max-iter=0", "--iter-cap", "8000",
        "--mu", "2.5", "--eps", "1e-4", "--allow-pseudo", "--presort", "on"])
    assert args.decoder == "ADMM" and args.max_iter == 0
    assert args.iter_cap == 8000 and args.mu == 2.5 and args.eps == 1e-4
    assert args.allow_pseudo and args.presort == "on"
    for dec in ("ML", "LP"):
        assert port_main.parse_args(["bec", "7_4_hamming", dec]).decoder == dec
    args = port_main.parse_args([
        "biawgn", "1200_3_6_ldpc", "ADMMA", "--layers", "50", "20",
        "--train", "--apprx", "3", "--cache_dir", "c", "--plots_dir", "p"])
    assert args.decoder == "ADMMA" and args.layers == [50, 20]
    assert args.train and args.apprx == 3
    assert args.cache_dir == "c" and args.plots_dir == "p"


def test_runner_random_codeword_and_caps():
    cfg = RunConfig(channel="biawgn", code="7_4_hamming", decoder="MSA",
                    params=[1.0], codeword=-1, min_wec=10 ** 9, batch=512,
                    max_words=2048, pipeline=2, device="cpu")
    runner = MonteCarloRunner(cfg)
    res = runner.run()[1.0]
    stats = runner.last_dispatch_stats
    assert stats["dispatched"] == stats["consumed"] == res["tot"] // 512
    assert res["tot"] == 2048                     # stopped by max_words
    assert 0 < res["wer"] < 1
    with pytest.raises(ValueError, match="generator"):
        MonteCarloRunner(RunConfig(channel="biawgn", code="1200_3_6_ldpc",
                                   decoder="MSA", codeword=-1, device="cpu"))
    # ADMMA in eval mode needs a trained model in its cache directory.
    for channel in ("bec", "bsc"):
        with pytest.raises(FileNotFoundError, match="model_4-100-100-4"):
            MonteCarloRunner(RunConfig(channel=channel, code="7_4_hamming",
                                       decoder="ADMMA", device="cpu",
                                       cache_dir=os.path.join(ROOT, "none")))
    with pytest.raises(ValueError, match="inf_policy"):
        MonteCarloRunner(RunConfig(channel="bsc", code="7_4_hamming",
                                   decoder="SPA", inf_policy="clip",
                                   device="cpu"))


def test_saver_file_equals_jax(tmp_path):
    ids = [("channel", "biawgn"), ("code", "c"), ("decoder", "MSA"),
           ("codeword", 1), ("min_wec", 5), ("max_iter", 10)]
    files = []
    for cls, sub in ((JaxSaver, "jax"), (Saver, "port")):
        s = cls(str(tmp_path / sub), ids)
        s.add(2.0, {"tot": 10, "wer": 0.5})
        s.add(2.5, {"tot": 20, "wer": 0.25})
        files.append(open(s.file_path).read())
        assert os.path.basename(s.file_path) == "biawgn-c-MSA-1-5-10.json"
    assert files[0] == files[1]


def _z_against_golden(saved, name, key):
    with open(os.path.join(ROOT, "artifacts", "data", name)) as fp:
        ref = json.load(fp)
    assert list(saved) == list(ref)               # the JAX Saver schema
    w_o, t_o = saved["wer"][key], saved["tot"][key]
    w_r, t_r = ref["wer"][key], ref["tot"][key]
    return (w_o - w_r) / math.sqrt(_ac_var(w_o, t_o) + _ac_var(w_r, t_r))


def test_cli_admm_cpu_saver_has_iteration_histogram(tmp_path):
    name = "bsc-7_4_hamming-ADMM-1-300-3.0-1e-05-50-False.json"
    res = port_main.main([
        "bsc", "7_4_hamming", "ADMM", "--max-iter", "50", "--params", "0.1",
        "--codeword", "1", "--min-wec", "300", "--batch", "1024", "--device",
        "cpu", "--presort", "on", "--console", "--data_dir", str(tmp_path)])
    saved = json.loads((tmp_path / name).read_text())
    assert list(saved)[-3:] == ["ber", "dec", "words_per_sec"]
    dec = saved["dec"]["0.1"]
    assert list(dec) == ["average", "iter"] and len(dec["iter"]) == 2000
    assert sum(dec["iter"]) == saved["tot"]["0.1"]
    assert max(i for i, n in enumerate(dec["iter"]) if n) <= 50
    assert dec["average"] == pytest.approx(
        np.dot(dec["iter"], np.arange(2000)) / saved["tot"]["0.1"])
    assert res[0.1]["dec"]["iter"] == dec["iter"]
    assert abs(_z_against_golden(saved, name, "0.1")) <= 4.0


@pytest.mark.parametrize("channel,decoder,param,name", [
    ("bsc", "ML", 0.1, "bsc-7_4_hamming-ML-1-300.json"),
    ("bec", "ML", 0.3, "bec-7_4_hamming-ML-1-300.json"),
    ("biawgn", "ML", 3.0, "biawgn-7_4_hamming-ML-1-300.json"),
    ("bsc", "LP", 0.1, "bsc-7_4_hamming-LP-1-300-10-False.json"),
    ("bec", "LP", 0.3, "bec-7_4_hamming-LP-1-300-10-False.json"),
    ("biawgn", "LP", 3.0, "biawgn-7_4_hamming-LP-1-300-10-False.json"),
    ("bec", "ADMM", 0.3, "bec-7_4_hamming-ADMM-1-300-3.0-1e-05-50-False.json"),
    ("biawgn", "ADMM", 3.0,
     "biawgn-7_4_hamming-ADMM-1-300-3.0-1e-05-50-False.json"),
])
def test_cli_hamming_cpu_runs_match_goldens(tmp_path, channel, decoder, param,
                                            name):
    argv = [channel, "7_4_hamming", decoder, "--params", str(param),
            "--codeword", "1", "--min-wec", "300", "--batch", "1024",
            "--device", "cpu", "--console", "--data_dir", str(tmp_path)]
    if decoder == "ADMM":
        argv += ["--max-iter", "50"]
    port_main.main(argv)
    saved = json.loads((tmp_path / name).read_text())
    z = _z_against_golden(saved, name, str(param))
    assert abs(z) <= 4.0, (saved["wer"], z)


def test_packed_tally_shapes_admm_and_host_chunk():
    """The ADMM chunk packs [wec, bec] + the 2000-bin histogram into one
    vector; the host-only (LP) chunk returns the plain [wec, bec] pair
    through the same dispatch, at pipeline depth 1."""
    common = dict(channel="bsc", code="7_4_hamming", params=[0.1],
                  codeword=1, batch=256, device="cpu")
    admm = MonteCarloRunner(RunConfig(decoder="ADMM", max_iter=0,
                                      iter_cap=3000, **common))
    assert admm.track_hist and not admm.host_only
    tally, event = admm._dispatch(0.1, admm._generator(0))
    assert event is None and tally.shape == (2002,)
    assert tally.dtype == torch.int64 and int(tally[2:].sum()) == 256
    assert 0 < int(tally[0]) < 256
    # iteration counts beyond the last bin clip into it
    admm.dec.decode = lambda y, p, g: (
        torch.ones((256, 7), dtype=torch.int32),
        {"iters": torch.full((256,), 2500, dtype=torch.int32)})
    tally, _ = admm._dispatch(0.1, admm._generator(0))
    assert int(tally[2 + 1999]) == 256 and int(tally[0]) == 0

    lp = MonteCarloRunner(RunConfig(decoder="LP", min_wec=20, pipeline=4,
                                    **common))
    assert lp.host_only and not lp.track_hist
    tally, event = lp._dispatch(0.1, lp._generator(0))
    assert event is None and tally.shape == (2,) and not tally.is_cuda
    res = lp.run()[0.1]
    assert res["wec"] >= 20 and "dec" not in res
    assert lp.last_dispatch_stats["dispatched"] == res["tot"] // 256


def test_port_imports_no_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import ldpc_decoders_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = ['codes.ensembles', 'decoders.bp_ensemble',"
        " 'harness.ensemble_runner', 'viz.ens_average',"
        " 'design.density_evolution', 'decoders.admma', 'viz.graph',"
        " 'viz.cases', 'viz.polytope', 'utils.mpl', 'parallel.mesh',"
        " 'parallel.bp_edge_sharded', 'parallel.jobs']\n"
        "assert all(p.__name__ + '.' + m in sys.modules for m in need)\n"
        "assert 'matplotlib' not in sys.modules\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('ldpc_decoders_tpu') and not"
        " m.startswith('ldpc_decoders_tpu_torch')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules"
        " if m.startswith('ldpc_decoders_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
