"""PyTorch port: the Monte-Carlo slice as a whole against the JAX package.

- one chunk's packed [wec, bec] tally from the same injected noise equals
  the JAX runner's (bf16, where the port is bit-equal to the incidence
  route);
- the CLI on the CPU writes the JAX package's Saver file, with a WER
  within |z| <= 4 (Agresti-Coull, docs/PARITY.md) of the committed
  artifact;
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


@pytest.mark.parametrize("argv", [
    ["bec", "1200_3_6_ldpc", "ML"],
    ["bec", "1200_3_6_ldpc", "ADMM"],
    ["bsc", "1200_3_6_ldpc", "ADMM"],
    ["biawgn", "1200_3_6_ldpc", "MSA", "--mu", "2.0"],
    ["biawgn", "1200_3_6_ldpc", "MSA", "--mesh", "2"],
    ["biawgn", "1200_3_6_ldpc", "MSA", "--kernel", "xla"],
    ["bsc", "1200_3_6_ldpc", "ML"],
    ["bsc", "1200_3_6_ldpc", "SPA", "--mesh-code", "2"],
])
def test_cli_refuses_unported(argv, capsys):
    with pytest.raises(SystemExit) as e:
        port_main.parse_args(argv)
    assert e.value.code != 0
    assert "not ported yet (ROADMAP" in capsys.readouterr().err


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MonteCarloRunner(RunConfig(channel="bec", code="7_4_hamming",
                                   decoder="ML", device="cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MonteCarloRunner(RunConfig(channel="bsc", code="7_4_hamming",
                                   decoder="ADMM", device="cpu"))
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


def test_port_imports_no_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import ldpc_decoders_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
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
