"""PyTorch port: the Saver's file (``harness/saver.py``), which each
``Saver`` writes from the document it holds, its entries kept encoded.

- after every ``add`` and ``add_all`` the file holds the bytes of
  ``json.dump(..., indent=4)`` of the reloaded and merged document, and
  the JAX package's ``Saver``'s bytes on the same calls: the sweep's 16
  parameters repeated, a parameter overwritten, a key that first appears
  at a later add, ADMM's ``dec`` with its 2000-bin histogram, run ids of
  every JSON scalar type, NaN and infinities, empty objects and lists
  and an empty document, ``add_all``;
- a file left by an earlier run is merged at the first add;
- a file another writer replaced, rewrote or deleted between two adds is
  read again (``saver_reloads`` counts it) and merged as the JAX
  ``Saver`` merges it; a corrupt one starts afresh from the run ids;
- a write whose rename fails leaves the previous file whole, and the next
  add merges into that file.
"""

import json
import math
import os
from collections import OrderedDict
from pathlib import Path

import pytest

from ldpc_decoders_tpu.harness.saver import Saver as JaxSaver
from ldpc_decoders_tpu_torch.harness import Saver
from ldpc_decoders_tpu_torch.utils import profiler

IDS = [("channel", "biawgn"), ("code", "1200_3_6"), ("decoder", "MSA"),
       ("codeword", 1), ("min_wec", 100), ("max_iter", 10)]
SWEEP = [0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0, 2.2, 2.3, 2.4, 2.5, 2.6, 2.7,
         2.8, 2.9, 3.0]


def status(i: int, dec: bool = False) -> OrderedDict:
    """A point's values as ``MonteCarloRunner``'s ``status`` gives them."""
    tot, wec = 16384 * (i % 7 + 1), 100 + 37 * i
    bec = 13 * wec + i
    vals = OrderedDict([("tot", tot), ("wec", wec), ("wer", wec / tot),
                        ("bec", bec), ("ber", bec / (tot * 1200))])
    if dec:
        hist = [0] * 2000
        for j in range(60 + i):
            hist[(j * j + 3 * i) % 2000] += j + 1
        avg = sum(k * n for k, n in enumerate(hist)) / sum(hist)
        vals["dec"] = {"average": avg, "iter": hist}
    vals["words_per_sec"] = tot / (0.0031 + 1e-4 * i)
    return vals


def adds(params, dec=False, start=0):
    return [("add", p, status(start + i, dec)) for i, p in enumerate(params)]


CASES = {
    "sweep_repeated": (IDS, adds(SWEEP * 3)),
    "param_overwritten": (IDS, adds([1.0, 2.0, 1.0, 2.0, 3.0, 1.0])),
    "key_late": (IDS, adds([1.0, 2.0]) + [
        ("add", 3.0, OrderedDict([("tot", 5), ("extra", "first")])),
        ("add", 1.0, OrderedDict([("extra", {"a": [1, 2.5]})]))]
        + adds([4.0], start=9)),
    "admm_dec": ([("channel", "bsc"), ("code", "margulis"),
                  ("decoder", "ADMM"), ("codeword", 1), ("min_wec", 100),
                  ("mu", 3.0), ("eps", 1e-05), ("max_iter", 8000),
                  ("presort", False)],
                 adds([0.06, 0.07, 0.06, 0.08], dec=True)),
    "run_id_types": ([("codeword", 1), ("eps", 1e-05), ("presort", False),
                      ("name", "xé \"q\""), ("none", None)],
                     adds([0.5, 1, "3.0"])),
    "nan_and_inf": (IDS, [
        ("add", 1.0, OrderedDict([("tot", 0), ("wer", math.nan),
                                  ("ber", math.inf)])),
        ("add", 2.0, OrderedDict([("wer", -math.inf), ("ber", 0.0)])),
        ("add", 1.0, OrderedDict([("wer", 0.5), ("ber", math.nan)]))]),
    "empty": ([], [
        ("add_all", {}),
        ("add", 1.0, {}),
        ("add_all", {"arr": {}, "lst": []}),
        ("add", 1.0, OrderedDict([("tot", {}), ("l", [])]))]),
    "add_all": (IDS, [
        ("add_all", {"arr": [[1, 0.25, 3], [2, 0.5, 4]]}),
        ("add", 1.0, status(0)),
        ("add_all", {"arr": [[1, 0.25, 3], [2, 0.5, 4], [3, 1e-07, 5]]}),
        ("add_all", {"arr": []})]),
}


def reference(path: str, ids, op: str, *args) -> None:
    """Reload, merge and ``json.dump(indent=4)``: the bytes each call has
    to leave."""
    if op == "add_all":
        data = OrderedDict(ids)
        data.update(args[0])
    else:
        param, vals = args
        try:
            with open(path) as fp:
                data = json.load(fp, object_pairs_hook=OrderedDict)
        except (OSError, ValueError):
            data = None
        if data is None:
            data = OrderedDict(ids)
            for key in vals:
                data[key] = {}
        for key in vals:
            data.setdefault(key, {})[str(param)] = vals[key]
    with open(path, "w") as fp:
        json.dump(data, fp, indent=4)


@pytest.fixture(autouse=True)
def _no_recorder():
    profiler.disable()
    yield
    profiler.disable()


def _pair(tmp_path, ids):
    """The port's Saver and the JAX package's, each in its own directory."""
    return (Saver(str(tmp_path / "port"), ids),
            JaxSaver(str(tmp_path / "jax"), ids))


def _call(savers, op, *args):
    for s in savers:
        getattr(s, op)(*args)


def _same(port, jax) -> bytes:
    got = Path(port.file_path).read_bytes()
    assert got == Path(jax.file_path).read_bytes()
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_file_is_json_dump_of_the_merge_after_every_call(case, tmp_path):
    ids, calls = CASES[case]
    port, jax = _pair(tmp_path, ids)
    ref = str(tmp_path / "ref.json")
    rec = profiler.enable()
    for op, *args in calls:
        _call((port, jax), op, *args)
        reference(ref, ids, op, *args)
        assert _same(port, jax) == Path(ref).read_bytes()
    first = calls[0][0] == "add"
    assert rec.counters.get("saver_reloads", 0) == int(first)


def test_a_file_left_by_an_earlier_run_is_merged_at_the_first_add(tmp_path):
    for sub in ("port", "jax"):
        earlier = JaxSaver(str(tmp_path / sub), IDS)
        for op, *args in adds([0.5, 1.0, 2.0]):
            earlier.add(*args)
    port, jax = _pair(tmp_path, IDS)
    rec = profiler.enable()
    for op, *args in adds([1.0, 3.0, 0.5], start=5):
        _call((port, jax), op, *args)
        _same(port, jax)
    saved = json.loads(Path(port.file_path).read_text())
    assert list(saved["tot"]) == ["0.5", "1.0", "2.0", "3.0"]
    assert rec.counters == {"saver_reloads": 1}


def _rewrite(path: str) -> None:
    """Another writer's edit in place: the same inode, other bytes."""
    data = json.loads(Path(path).read_text(), object_pairs_hook=OrderedDict)
    data["tot"]["9.5"] = 7
    data["note"] = "edited"
    with open(path, "w") as fp:
        json.dump(data, fp, indent=4)


@pytest.mark.parametrize("writer", ["another_saver", "rewritten_in_place",
                                    "deleted", "corrupt"])
def test_a_file_changed_by_another_writer_is_read_again(writer, tmp_path):
    port, jax = _pair(tmp_path, IDS)
    for op, *args in adds([0.5, 1.0]):
        _call((port, jax), op, *args)
    rec = profiler.enable()
    for s, cls in ((port, Saver), (jax, JaxSaver)):
        if writer == "another_saver":
            cls(os.path.dirname(s.file_path), IDS).add(9.0, status(9))
        elif writer == "rewritten_in_place":
            _rewrite(s.file_path)
        elif writer == "deleted":
            os.remove(s.file_path)
        else:
            Path(s.file_path).write_text('{"tot": {"0.5": ')
    reloads = rec.counters.get("saver_reloads", 0)
    for op, *args in adds([2.0, 0.5, 3.0], start=3):
        _call((port, jax), op, *args)
        _same(port, jax)
    assert rec.counters["saver_reloads"] == reloads + 1
    saved = json.loads(Path(port.file_path).read_text())
    want = {"another_saver": ["0.5", "1.0", "9.0", "2.0", "3.0"],
            "rewritten_in_place": ["0.5", "1.0", "9.5", "2.0", "3.0"],
            "deleted": ["2.0", "0.5", "3.0"],
            "corrupt": ["2.0", "0.5", "3.0"]}[writer]
    assert list(saved["tot"]) == want
    assert list(saved)[:len(IDS)] == [k for k, _ in IDS]


def test_a_failed_rename_leaves_the_previous_file_whole(tmp_path,
                                                        monkeypatch):
    port, jax = _pair(tmp_path, IDS)
    for op, *args in adds([0.5, 1.0]):
        _call((port, jax), op, *args)
    before = _same(port, jax)

    def refuse(src, dst):
        raise OSError("rename refused")

    with monkeypatch.context() as m:
        m.setattr(os, "replace", refuse)
        for s in (port, jax):
            with pytest.raises(OSError, match="rename refused"):
                s.add(2.0, status(2))
        assert _same(port, jax) == before
    rec = profiler.enable()
    for op, *args in adds([3.0, 1.0], start=4):
        _call((port, jax), op, *args)
        _same(port, jax)
    assert list(json.loads(Path(port.file_path).read_text())["tot"]) == [
        "0.5", "1.0", "3.0"]
    assert rec.counters == {"saver_reloads": 1}
