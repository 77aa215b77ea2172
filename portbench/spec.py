"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cells (a configuration and a traffic mix each) and
the metrics; ``configs/<config>.json``, ``traffic/<mix>.json``,
``entries/<entry>.py``, ``metrics/<metric>.py`` and
``reference/decoders/<decoder>.py`` hold what belongs to each. Nothing
here imports the program."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as fp:
        return json.load(fp)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def config_file(bench: dict, name: str) -> str:
    for c in bench["configs"]:
        if c["name"] == name:
            return os.path.join(ROOT, c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(mix: str) -> str:
    return os.path.join(HERE, "traffic", f"{mix}.json")


def cell(bench: dict, workload: str) -> dict:
    """The cell ``workload``: its entry in ``workloads``, its configuration
    and traffic files read, and the metrics it reports."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    config = load_json(config_file(bench, w["config"]))
    reference_decoder_file(config["run_config"]["decoder"])

    def reports(m):
        return workload in m.get("workloads", [workload])

    return {
        "name": workload, "chips": int(w["chips"]),
        "config": config,
        "traffic": load_json(traffic_file(w["traffic"])),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def _module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind.replace('/', '.')}.{name.replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    """``entries/<name>.py``: what a cell's window drives."""
    return _module("entries", name)


def metric_reader(name: str):
    """The reader of one per-layer metric: ``metrics/<name>.py``, or, for a
    quantity split by the end-to-end metric it moves (``device.idle_pct.cw``
    and ``device.idle_pct.point``), the reader of the name without its last
    dotted parts (``metrics/device.idle_pct.py``)."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        stem = ".".join(parts[:n])
        if os.path.exists(os.path.join(HERE, "metrics", f"{stem}.py")):
            return _module("metrics", stem)
    raise KeyError(f"no reader in metrics/ for {name!r}")


def reference_decoder_file(decoder: str) -> str:
    """``reference/decoders/<decoder>.py``; a decoder with no file there
    has no reference, and its cell is refused."""
    path = os.path.join(HERE, "reference", "decoders", f"{decoder}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"the reference has no decoder {decoder!r}: add "
            f"{os.path.relpath(path, ROOT)} (reference/decoders/"
            f"__init__.py says what it holds)")
    return path


def reference_decoder(decoder: str):
    """The plain reference of the decoder a configuration names:
    ``reference/decoders/<decoder>.py``."""
    reference_decoder_file(decoder)
    return _module("reference/decoders", decoder)
