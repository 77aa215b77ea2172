"""The reference decoders are found by name: a decoder's file in
``reference/decoders/`` is all that a cell for a new decoder adds to the
check, its histogram flag follows the program's, and a cell whose decoder
has no file is refused before its set-up."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from ldpc_decoders_tpu_torch.channels import CHANNELS
from ldpc_decoders_tpu_torch.harness.runner import MonteCarloRunner, RunConfig
from portbench import check, control, run, spec
from portbench.tests.conftest import TINY

DECODERS = os.path.join(spec.HERE, "reference", "decoders")
# A decode that flips one decision of each batch it returns, appended to a
# copy of a decoder's file.
FLIP = '''

_sound = decoder


def decoder(run_config, tables, precision=None):
    decode = _sound(run_config, tables, precision)

    def flipped(llr):
        x_hat, iters = decode(llr)
        x_hat = x_hat.clone()
        x_hat[0, 0] ^= 1
        return x_hat, iters

    return flipped
'''


def decoder_text(name):
    with open(os.path.join(DECODERS, f"{name}.py")) as fp:
        return fp.read()


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    """A checkout of its own (``BENCHMARK.json``, a copy of ``portbench/``
    and the codes) in which the harness looks everything up."""
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    (tmp_path / "data").symlink_to(os.path.join(spec.ROOT, "data"))
    monkeypatch.setattr(spec, "ROOT", str(tmp_path))
    monkeypatch.setattr(spec, "HERE", str(tmp_path / "portbench"))
    return tmp_path


def add_cell(root, like, decoder):
    """A configuration and a cell like the cell ``like``, whose run config
    names ``decoder``: new data files and entries, nothing else."""
    bench = spec.benchmark(str(root))
    base = next(w for w in bench["workloads"] if w["name"] == like)
    config = spec.load_json(spec.config_file(bench, base["config"]))
    config["run_config"]["decoder"] = decoder
    name = f"standin_{decoder.lower()}"
    with open(root / "portbench" / "configs" / f"{name}.json", "w") as fp:
        json.dump(config, fp)
    src = next(c for c in bench["configs"] if c["name"] == base["config"])
    bench["configs"].append(dict(src, name=name,
                                 file=f"portbench/configs/{name}.json"))
    bench["workloads"].append(dict(base, name=f"{name}.{base['traffic']}",
                                   config=name))
    with open(root / "BENCHMARK.json", "w") as fp:
        json.dump(bench, fp)
    return spec.cell(spec.benchmark(str(root)), f"{name}.{base['traffic']}")


def alias(monkeypatch, decoder, program_decoder):
    """The program runs ``program_decoder`` under the stand-in's name."""
    for mod in CHANNELS.values():
        monkeypatch.setitem(mod.DECODERS, decoder,
                            mod.DECODERS[program_decoder])


def standin(root, monkeypatch, like, program_decoder, text):
    decoder = f"{program_decoder}_STANDIN"
    with open(root / "portbench" / "reference" / "decoders"
              / f"{decoder}.py", "w") as fp:
        fp.write(text)
    alias(monkeypatch, decoder, program_decoder)
    return add_cell(root, like, decoder)


def tiny_run(cell, like, seed=2 ** 33 + 7):
    return run.run_cell(cell, seed, 0.0, False, device="cpu",
                        overrides=TINY[like], t_start=time.perf_counter())


@pytest.mark.parametrize("flip", [False, True], ids=["sound", "flipped"])
def test_a_standin_decoder_is_found_with_no_other_edit(checkout,
                                                       monkeypatch, flip):
    """Min-sum under a new name: its file alone makes the check replay it;
    a file whose decode flips one decision makes the run not correct."""
    like = "ldpc1200_msa.deep"
    text = decoder_text("MSA") + (FLIP if flip else "")
    cell = standin(checkout, monkeypatch, like, "MSA", text)
    assert cell["config"]["run_config"]["decoder"] == "MSA_STANDIN"
    out, lines = tiny_run(cell, like)
    assert out["correct"] is (not flip)
    assert (out["checks"]["tally_diff"]["value"] > 0) is flip
    assert set(out["checks"]) == {"tally_diff"}


@pytest.mark.parametrize("keeps", [True, False], ids=["keeps", "keeps_none"])
def test_the_histogram_flag_sets_hist_diff(checkout, monkeypatch, keeps):
    """ADMM under a new name, its file's flag set or not: ``hist_diff`` is
    in the line and in the control where the flag is set, and only
    there."""
    like = "margulis_admm.bsc06"
    text = decoder_text("ADMM").replace(
        "TRACK_ITER_HIST = True", f"TRACK_ITER_HIST = {keeps}")
    cell = standin(checkout, monkeypatch, like, "ADMM", text)
    out, lines = tiny_run(cell, like)
    assert out["correct"] is True
    assert ("hist_diff" in out["checks"]) is keeps
    assert any(ln.startswith("check hist_diff") for ln in lines) is keeps
    ctl = control.control_numbers(cell, 2 ** 33 + 11, "cpu", TINY[like])
    assert ctl["precision"] == "bfloat16" and ctl["fails"]
    assert ("hist_diff" in ctl["numbers"]) is keeps
    if keeps:
        assert ctl["numbers"]["hist_diff"] > 0


@pytest.mark.parametrize("config", sorted(
    c["name"] for c in spec.benchmark()["configs"]))
def test_the_histogram_flag_is_the_programs(bench, config):
    cfg = spec.load_json(spec.config_file(bench, config))
    rc = dict(cfg["run_config"], batch=16)
    runner = MonteCarloRunner(RunConfig(**rc, params=cfg["params"][:1],
                                        device="cpu", log_freq=1e9))
    ref = spec.reference_decoder(rc["decoder"])
    assert ref.TRACK_ITER_HIST is runner.track_hist


@pytest.mark.parametrize("config", sorted(
    c["name"] for c in spec.benchmark()["configs"]))
def test_the_control_is_one_precision_lower(bench, config):
    cfg = spec.load_json(spec.config_file(bench, config))
    rc = cfg["run_config"]
    low = spec.reference_decoder(rc["decoder"]).control_precision(rc)
    stated = rc.get("msg_dtype", "float32")
    assert (torch.finfo(getattr(torch, low)).bits
            < torch.finfo(getattr(torch, stated)).bits)


def no_decoder(root):
    """The deep cell's configuration, naming a decoder with no file."""
    path = root / "portbench" / "configs" / "ldpc1200_msa.json"
    config = spec.load_json(str(path))
    config["run_config"]["decoder"] = "SPA"
    with open(path, "w") as fp:
        json.dump(config, fp)
    assert not os.path.exists(root / "portbench" / "reference" / "decoders"
                              / "SPA.py")


def test_a_decoder_with_no_file_is_refused_at_load(checkout):
    no_decoder(checkout)
    with pytest.raises(FileNotFoundError,
                       match="portbench/reference/decoders/SPA.py"):
        spec.cell(spec.benchmark(str(checkout)), "ldpc1200_msa.deep")
    with pytest.raises(FileNotFoundError, match="SPA"):
        spec.reference_decoder("SPA")


def test_the_cli_refuses_a_decoder_with_no_file(checkout):
    """Exit code 1 with no result line, the file to add named, before the
    look for a card (exit code 2 here) and so before set-up."""
    no_decoder(checkout)
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "ldpc1200_msa.deep", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=checkout, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(checkout)))
    assert proc.returncode == 1 and proc.stdout.strip() == ""
    assert "portbench/reference/decoders/SPA.py" in proc.stderr
    assert "phase" not in proc.stderr


@pytest.mark.parametrize("module", [check, control, run, spec],
                         ids=lambda m: m.__name__)
def test_the_harness_names_no_decoder(module):
    """The decoder's choice, its control's precision and its histogram flag
    live in its file alone."""
    names = {os.path.basename(p)[:-3]
             for p in glob.glob(os.path.join(DECODERS, "*.py"))} - {
        "__init__"}
    with open(module.__file__) as fp:
        tree = ast.parse(fp.read())
    strings = {n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert names and not names & strings
