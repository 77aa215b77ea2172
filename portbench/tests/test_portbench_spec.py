"""BENCHMARK.json against the benchmark's contract, and every name in it
found by the harness."""

import json
import os
import re

import pytest

from portbench import spec
from portbench.tests.conftest import TINY

KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                   r"|(_dim|_rank)$|expansion|experts_per_token")


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == KEYS
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.endswith("_torch") and os.path.isdir(
            os.path.join(spec.ROOT, p))
    cmd = bench["command"]
    assert len(cmd) <= 32 and all(line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    module = cmd[cmd.index("-m") + 1]
    assert module.split(".")[0] in bench["paths"]


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for e in bench[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key]), (e["name"], key)


def test_configs_resolve(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        cfg = spec.load_json(spec.config_file(bench, c["name"]))
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(spec.HERE, "entries",
                                           cfg["entry"] + ".py"))
        code = cfg["run_config"]["code"]
        assert os.path.exists(os.path.join(spec.ROOT, "data", "codes",
                                           f"{code}.txt"))


def test_cells_resolve_and_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(spec.traffic_file(w["traffic"]))
        cell = spec.cell(bench, w["name"])
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in names, (w["name"], m["name"])
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)


def test_per_layer_metrics_have_readers(bench):
    layers = {}
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert callable(spec.metric_reader(m["name"]).read)
        if m["name"].endswith("roofline_pct"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("name,stem", [
    ("msa_decode.roofline_pct", "msa_decode.roofline_pct"),
    ("device.idle_pct.point", "device.idle_pct"),
    ("torch_ops.ms_per_chunk.converge", "torch_ops.ms_per_chunk")])
def test_a_split_metric_shares_its_quantitys_reader(name, stem):
    assert spec.metric_reader(name).__file__ == os.path.join(
        spec.HERE, "metrics", f"{stem}.py")


def test_a_metric_with_no_reader_is_refused():
    with pytest.raises(KeyError):
        spec.metric_reader("no_such.metric")


def test_tiny_overrides_cover_every_cell(bench):
    assert {w["name"] for w in bench["workloads"]} == set(TINY)
    json.dumps(TINY)
