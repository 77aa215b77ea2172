"""The program's spans in the harness (``spans.py`` and the five readers
that use it): hand-computed values on a synthetic window, nothing where the
program records no spans, the idle gaps named by the innermost span, and a
tiny traced run of the sweep cell with and without the program's
recorder."""

import time

import pytest
import torch

from portbench import run, spans, spec, trace
from portbench.tests.conftest import TINY
from ldpc_decoders_tpu_torch.utils import profiler
from ldpc_decoders_tpu_torch.utils.profiler import Span

NEW = {"saver.ms_per_point": 250.0, "runner.log_ms_per_point": 500.0,
       "runner.dispatch_ms_per_point": 350.0,
       "runner.wait_ms_per_point": 2800.0, "host.gc_ms_per_point": 400.0}
# What the sweep cell's traced line holds on the CPU, where the window
# records no device operation, with the parent's program.
PARENT_LINE = {"runner.point_ms_p95"}


@pytest.fixture(autouse=True)
def _no_recorder():
    profiler.disable()
    yield
    profiler.disable()


def recorded(rows) -> profiler.Recorder:
    rec = profiler.Recorder()
    rec.spans = [Span(i, *row) for i, row in enumerate(rows)]
    return rec


# A 10 s window, two points: (name, start, end, parent, point, arg).
SPANS = [("point", 0.0, 4.8, -1, 0, 3.0),
         ("dispatch", 0.5, 1.0, 0, 0, None),
         ("wait", 1.0, 3.0, 0, 0, None),
         ("log", 3.0, 4.5, 0, 0, None),
         ("saver", 3.5, 4.0, 3, 0, None),
         ("gc", 4.1, 4.3, 3, 0, 0),
         ("point", 5.2, 10.5, -1, 1, 3.0),
         ("dispatch", 5.2, 5.4, 6, 1, None),
         ("wait", 5.4, 9.0, 6, 1, None),
         ("gc", 9.0, 9.6, 6, 1, 2),
         ("log", 9.8, 10.4, 6, 1, None),
         ("saver", -2.0, -1.0, -1, -1, None)]
OPS = [trace.Op("void msa_decode_kernel<6>(float*)", a, b)
       for a, b in [(0.0, 0.6), (1.0, 3.4), (4.0, 4.55), (4.7, 4.85),
                    (5.3, 9.0)]]
POINTS = [{"start": 0.0, "end": 4.8, "param": 3.0, "tot": 1000},
          {"start": 5.2, "end": 10.0, "param": 3.0, "tot": 1000}]


def context(ops=OPS, points=POINTS):
    return trace.Context(
        ops=ops, t_open=0.0, t_close=10.0, points=points,
        config={"run_config": {"decoder": "MSA"}}, traffic={}, batch=100,
        graph={"n_var": 1200, "n_edge": 3600, "dc": 6},
        reference={"words": 1000, "iterations": 5000},
        kernels={"msa_decode_kernel": "msa_decode.cu"})


def test_new_metrics_are_listed_for_the_sweep_cell(bench):
    cell = spec.cell(bench, "ldpc1200_msa.sweep")
    listed = {m["name"]: m for m in cell["per_layer"]}
    for name in NEW:
        m = listed[name]
        assert (m["unit"], m["better"], m["source"], m["layer"],
                m["moves"], m["workloads"]) == (
            "ms/point", "lower", "program_span", "runner and Saver",
            "ms_per_point", ["ldpc1200_msa.sweep"])


def test_readers_on_synthetic_spans(monkeypatch):
    monkeypatch.setattr(profiler, "_last", recorded(SPANS))
    ctx = context()
    got = {n: spec.metric_reader(n).read(ctx) for n in NEW}
    assert got == pytest.approx(NEW)


def _no_last(monkeypatch):
    """The parent's program: a profiler module with no recorder."""
    monkeypatch.delattr(profiler, "last")


def _nothing_in_the_window(monkeypatch):
    monkeypatch.setattr(profiler, "_last",
                        recorded([("saver", -2.0, -1.0, -1, -1, None)]))


def _never_enabled(monkeypatch):
    monkeypatch.setattr(profiler, "_last", None)


@pytest.mark.parametrize("absent", [_no_last, _nothing_in_the_window,
                                    _never_enabled],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("name", sorted(NEW))
def test_a_reader_finds_nothing_without_program_spans(name, absent,
                                                      monkeypatch):
    absent(monkeypatch)
    assert spec.metric_reader(name).read(context()) is None


def test_a_reader_finds_nothing_without_points(monkeypatch):
    monkeypatch.setattr(profiler, "_last", recorded(SPANS))
    for name in NEW:
        assert spec.metric_reader(name).read(context(points=[])) is None


@pytest.mark.parametrize("absent", [_no_last, _never_enabled],
                         ids=lambda f: f.__name__.strip("_"))
def test_breakdown_without_spans_is_the_harness_breakdown(absent,
                                                          monkeypatch):
    absent(monkeypatch)
    ctx = context()
    assert spans.breakdown(ctx) == trace.breakdown(ctx)


def test_breakdown_names_each_gap_by_the_innermost_span(monkeypatch):
    monkeypatch.setattr(profiler, "_last", recorded(SPANS))
    ctx = context()
    bd = spans.breakdown(ctx)
    assert bd["device_ops"] == trace.breakdown(ctx)["device_ops"]
    assert [g[0] for g in bd["idle_gaps"]] == [
        "gc", "saver", spans.BETWEEN, "dispatch", "point"]
    assert [g[1] for g in bd["idle_gaps"]] == pytest.approx(
        [1.0, 0.6, 0.45, 0.4, 0.15])
    assert [g[1] for g in bd["idle_gaps"]] == [
        g[1] for g in trace.breakdown(ctx)["idle_gaps"]]


class _CpuProfilerWindow:
    """A traced window on the CPU: a ``torch.profiler`` session collects
    (so the program's recorder follows it), and no device operation is
    read."""

    def open(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        self.prof.start()

    def close(self):
        self.prof.stop()

    def ops(self):
        return []


def _traced_sweep(bench, seed):
    cell = spec.cell(bench, "ldpc1200_msa.sweep")
    out, _ = run.run_cell(cell, seed, 0.0, True, device="cpu",
                          overrides=TINY["ldpc1200_msa.sweep"],
                          t_start=time.perf_counter())
    return out


def test_a_traced_sweep_on_the_parents_program_prints_the_parents_line(
        bench, monkeypatch):
    monkeypatch.setattr(trace, "Window", _CpuProfilerWindow)
    _no_last(monkeypatch)
    plain = trace.breakdown
    monkeypatch.setattr(trace, "breakdown",
                        lambda ctx, top=10: spans.breakdown(ctx, top, plain))
    out = _traced_sweep(bench, 2 ** 33 + 11)
    assert out["correct"] is True
    assert set(out["metrics"]) == PARENT_LINE
    assert all(g[0].startswith("run_param ") or g[0] == spans.BETWEEN
               for g in out["breakdown"]["idle_gaps"])


def test_a_traced_sweep_reads_the_programs_spans(bench, monkeypatch):
    monkeypatch.setattr(trace, "Window", _CpuProfilerWindow)
    plain = trace.breakdown
    monkeypatch.setattr(trace, "breakdown",
                        lambda ctx, top=10: spans.breakdown(ctx, top, plain))
    out = _traced_sweep(bench, 2 ** 33 + 13)
    assert out["correct"] is True
    assert set(out["metrics"]) == PARENT_LINE | set(NEW)
    for name in NEW:
        assert out["metrics"][name]["value"] >= 0
        assert out["metrics"][name]["unit"] == "ms/point"
    for name in ("saver.ms_per_point", "runner.dispatch_ms_per_point",
                 "runner.wait_ms_per_point"):
        assert out["metrics"][name]["value"] > 0
    names = {g[0] for g in out["breakdown"]["idle_gaps"]}
    assert names <= {"point", "dispatch", "wait", "log", "saver", "gc",
                     spans.BETWEEN}
