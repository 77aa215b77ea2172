"""PyTorch port: the in-memory span and counter recorder
(``utils/profiler.py``) and its spans in the runner and the Saver.

- with no recorder on, a span site records nothing and reads no clock;
- spans nest with their parents and sweep points, on ``time.perf_counter``;
- ``Saver.add`` is one ``saver`` span holding one ``saver.write``, and
  counts ``saver_reloads`` only where it reads the file; a CPU
  ``run_param`` records ``point``, ``dispatch``, ``wait``, ``log`` and
  ``saver``, and counts the chunks ``last_dispatch_stats`` holds;
- ``log``'s self time (``portbench/spans.py``) is less its direct children
  alone, so ``saver.write`` inside ``saver`` is not taken off twice;
- a collection is a ``gc`` span while a recorder is on, and not after;
- ``RunConfig(profile=True)`` logs a summary every 20 chunks of a point;
- ``follow_torch`` keeps a recorder on while a torch profiler collects.
"""

import gc
import logging
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from ldpc_decoders_tpu_torch.harness import MonteCarloRunner, RunConfig, Saver  # noqa: E402
from portbench import spans as portbench_spans  # noqa: E402
from ldpc_decoders_tpu_torch.harness.runner import point_generator  # noqa: E402
from ldpc_decoders_tpu_torch.utils import profiler  # noqa: E402
from ldpc_decoders_tpu_torch.utils.profiler import Span  # noqa: E402

BATCH = 32


@pytest.fixture(autouse=True)
def _no_recorder():
    profiler.disable()
    yield
    profiler.disable()


def _runner(tmp_path, chunks=3, **kw):
    cfg = RunConfig(channel="biawgn", code="7_4_hamming", decoder="MSA",
                    params=[1.0], codeword=1, min_wec=10 ** 9, batch=BATCH,
                    max_words=BATCH * chunks, pipeline=2, device="cpu",
                    data_dir=str(tmp_path / "data"), **kw)
    return MonteCarloRunner(cfg)


def _run_point(runner):
    return runner.run_param(1.0, point_generator("cpu", 0, 0))


def _spans(rec):
    return [Span._make(s) for s in rec.spans]


def _no_clock():
    raise AssertionError("a span site read the clock with no recorder on")


@pytest.mark.parametrize("site", ["span", "count", "saver", "run_param"])
def test_with_no_recorder_a_site_records_nothing_and_reads_no_clock(
        site, tmp_path, monkeypatch):
    monkeypatch.setattr(profiler, "perf_counter", _no_clock)
    before = profiler.last()
    if site == "span":
        assert profiler.span("dispatch") is profiler._OFF
        with profiler.span("dispatch"):
            pass
    elif site == "count":
        profiler.count("chunks_dispatched", 3)
    elif site == "saver":
        Saver(str(tmp_path), [("code", "c")]).add(1.0, {"tot": 1})
    else:
        assert _run_point(_runner(tmp_path))["tot"] == 3 * BATCH
    assert profiler.active() is None and profiler.last() is before


def test_spans_nest_with_parents_and_points_on_perf_counter():
    rec = profiler.enable()
    with profiler.span("point", 2.5):
        with profiler.span("dispatch"):
            t_inside = time.perf_counter()
        with profiler.span("log"):
            with profiler.span("saver"):
                pass
    with profiler.span("point", 3.0):
        pass
    with profiler.span("wait"):
        pass
    assert profiler.disable() is rec and profiler.last() is rec
    by = {}
    for s in _spans(rec):
        by.setdefault(s.name, []).append(s)
    spans = [s for s in _spans(rec) if s.name != "gc"]
    assert [s.name for s in spans] == ["dispatch", "saver", "log", "point",
                                       "point", "wait"]
    p0, p1 = by["point"]
    assert (p0.arg, p0.point, p0.parent) == (2.5, 0, -1)
    assert (p1.arg, p1.point) == (3.0, 1)
    d, lg, sv = by["dispatch"][0], by["log"][0], by["saver"][0]
    assert d.parent == lg.parent == p0.id and sv.parent == lg.id
    assert d.point == lg.point == sv.point == 0 and by["wait"][0].point == -1
    assert d.start <= t_inside <= d.end
    assert p0.start <= d.start and lg.end <= p0.end <= p1.start
    assert len({s.id for s in _spans(rec)}) == len(rec.spans)


def test_saver_add_is_one_saver_span(tmp_path):
    rec = profiler.enable()
    saver = Saver(str(tmp_path), [("code", "c")])
    saver.add(1.0, {"tot": 1, "wer": 0.5})
    saver.add(2.0, {"tot": 2, "wer": 0.25})
    spans = [s for s in _spans(rec) if s.name != "gc"]
    assert [s.name for s in spans] == ["saver.write", "saver"] * 2
    for write, sv in zip(spans[0::2], spans[1::2]):
        assert (write.parent, sv.parent) == (sv.id, -1)
        assert sv.start <= write.start <= write.end <= sv.end
    assert rec.counters == {"saver_reloads": 1}


def test_log_self_time_is_less_its_direct_children_alone(tmp_path):
    runner = _runner(tmp_path, chunks=3)
    rec = profiler.enable()
    _run_point(runner)
    profiler.disable()
    spans = _spans(rec)
    by_id = {s.id: s for s in spans}
    logs = [s for s in spans if s.name == "log"]
    writes = [s for s in spans if s.name == "saver.write"]
    assert logs and len(writes) == sum(s.name == "saver" for s in spans)
    assert all(by_id[w.parent].name == "saver" for w in writes)
    ctx = SimpleNamespace(points=[1.0], t_open=min(s.start for s in spans),
                          t_close=max(s.end for s in spans))
    children = [s for s in spans if s.parent in {lg.id for lg in logs}]
    assert {s.name for s in children} <= {"saver", "gc"}
    want = sum(s.end - s.start for s in logs) - sum(
        s.end - s.start for s in children)
    assert portbench_spans.ms_per_point(ctx, "log", self_time=True) == (
        pytest.approx(1e3 * want))
    assert portbench_spans.ms_per_point(ctx, "saver") == pytest.approx(
        1e3 * sum(s.end - s.start for s in spans if s.name == "saver"))


def test_run_param_records_the_runner_spans_and_chunk_counts(tmp_path):
    runner = _runner(tmp_path, chunks=5)
    rec = profiler.enable()
    res = _run_point(runner)
    names = {s.name for s in _spans(rec)}
    assert {"point", "dispatch", "wait", "log", "saver"} <= names
    (point,) = [s for s in _spans(rec) if s.name == "point"]
    assert point.arg == 1.0
    for s in _spans(rec):
        if s.name in ("dispatch", "wait", "log"):
            assert s.parent == point.id and s.point == 0
    logs = {s.id for s in _spans(rec) if s.name == "log"}
    assert all(s.parent in logs for s in _spans(rec) if s.name == "saver")
    stats = runner.last_dispatch_stats
    assert rec.counters == {"chunks_dispatched": stats["dispatched"],
                            "chunks_consumed": stats["consumed"],
                            "saver_reloads": 1}
    assert stats["dispatched"] == res["tot"] // BATCH == 5
    assert sum(s.name == "dispatch" for s in _spans(rec)) == 5


def test_a_collection_is_a_gc_span_until_disable():
    rec = profiler.enable()
    with profiler.span("point", 1.0):
        gc.collect()
    gcs = [s for s in _spans(rec) if s.name == "gc" and s.arg == 2]
    assert gcs and all(s.point == 0 and s.start <= s.end for s in gcs)
    point = [s for s in _spans(rec) if s.name == "point"][0]
    assert all(s.parent == point.id for s in gcs)
    profiler.disable()
    assert rec._gc not in gc.callbacks
    n = len(rec.spans)
    gc.collect()
    assert len(rec.spans) == n


def test_profile_logs_a_summary_every_20_chunks(tmp_path, caplog):
    runner = _runner(tmp_path, chunks=45, profile=True)
    with caplog.at_level(logging.INFO):
        runner.run()
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Summary at[")]
    assert [ln.split(":")[0] for ln in lines] == ["Summary at[20] for[20]",
                                                  "Summary at[40] for[20]"]
    assert "'dispatch':" in lines[0] and "'wait':" in lines[0]
    assert profiler.active() is None


def test_a_recorder_follows_the_torch_profiler(tmp_path):
    runner = _runner(tmp_path, chunks=1)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        _run_point(runner)
        rec = profiler.active()
        assert rec is not None and rec.follows_torch
        assert [s.name for s in _spans(rec)].count("point") == 1
    finally:
        prof.stop()
    _run_point(runner)
    assert profiler.active() is None and profiler.last() is rec
    assert [s.name for s in _spans(rec)].count("point") == 1
    mine = profiler.enable()
    _run_point(runner)
    assert profiler.active() is mine
    with pytest.raises(RuntimeError, match="on already"):
        profiler.enable()
