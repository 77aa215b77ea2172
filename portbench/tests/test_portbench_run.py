"""A run of each cell, tiny and on the CPU: a well-formed result line, a
comparison that passes on the program and fails on each fault a cell can
have, the look for JAX at the window's close, the CLI's refusal without a
card, and the per-layer readers on a synthetic trace."""

import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import run, spec, trace
from portbench.tests.conftest import TINY

# The cells on one chip: this process runs them (``test_portbench_mesh.py``
# runs the cell on four ranks).
CELLS = sorted(w["name"] for w in spec.benchmark()["workloads"]
               if w["chips"] == 1)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_run(bench, name, seed=2 ** 33 + 3):
    cell = spec.cell(bench, name)
    return run.run_cell(cell, seed, 0.0, False, device="cpu",
                        overrides=TINY[name], t_start=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_prints_a_well_formed_line(bench, name):
    out, lines = tiny_run(bench, name)
    back = json.loads(json.dumps(out))
    assert list(back)[:5] == KEYS and list(back)[-1] == "checks"
    assert back["correct"] is True and back["failed"] == 0
    assert back["attempted"] >= 1
    want = {m["name"] for m in spec.cell(bench, name)["end_to_end"]}
    assert set(back["metrics"]) == want
    for m in back["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert all(c["value"] <= c["limit"] for c in back["checks"].values())
    assert lines[-len(back["checks"]):] == [
        f"check {k}: {c['value']} (limit {c['limit']})"
        for k, c in back["checks"].items()]


def test_a_one_chip_line_keeps_its_keys(bench, monkeypatch):
    """A cell on one chip runs in this process, as it did before cells on
    several ranks: the same keys, set-up phases and device fields."""
    def refuse(*a, **kw):
        raise AssertionError("a one-chip cell started ranks")

    monkeypatch.setattr(run, "run_ranks", refuse)
    out, _ = tiny_run(bench, "ldpc1200_msa.deep")
    assert list(out) == KEYS + ["phases_s", "points_checked", "checks"]
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    assert list(out["phases_s"]) == [
        "setup", "setup.harness", "setup.session", "setup.warm_up",
        "window", "reference"]
    assert out["attempted"] == 1 and out["points_checked"] == 1
    assert out["checks"] == {"tally_diff": {"value": 0, "limit": 0}}


def _flip(x_hat):
    x_hat = x_hat.clone()
    x_hat[0, 0] ^= 1
    return x_hat


def fault_unchanged(mp):
    """Every decode returns its input's hard decisions: no iteration ran."""
    from ldpc_decoders_tpu_torch.decoders import admm as dec_admm
    from ldpc_decoders_tpu_torch.decoders import bp as dec_bp

    def msa(llr, t, **kw):
        return ((llr < 0).to(torch.int32),
                torch.zeros(llr.shape[0], dtype=torch.int32))

    def adm(llr, t, **kw):
        return ((llr < 0).to(torch.int32),
                torch.zeros(llr.shape[0], dtype=torch.int32),
                (llr < 0).to(torch.float32))

    mp.setattr(dec_bp, "msa_decode", msa)
    mp.setattr(dec_admm, "admm_decode", adm)


def fault_half_batch(mp):
    """The tally counts the first half of the words and doubles it."""
    from ldpc_decoders_tpu_torch.ops import chunk_kernel

    real = chunk_kernel.tally

    def tally(x_hat, codeword=0, idx=None, cb=None, iters=None, **kw):
        h = x_hat.shape[0] // 2
        out = real(x_hat[:h], codeword, idx, cb,
                   iters=None if iters is None else iters[:h], **kw)
        return out * 2

    mp.setattr(chunk_kernel, "tally", tally)


def fault_altered_answer(mp):
    """One decision of each chunk flipped where the decoder makes it."""
    from ldpc_decoders_tpu_torch.decoders import admm as dec_admm
    from ldpc_decoders_tpu_torch.decoders import bp as dec_bp

    real_msa, real_admm = dec_bp.msa_decode, dec_admm.admm_decode

    def msa(llr, t, **kw):
        x, it = real_msa(llr, t, **kw)
        return _flip(x), it

    def adm(llr, t, **kw):
        x, it, xf = real_admm(llr, t, **kw)
        return _flip(x), it, xf

    mp.setattr(dec_bp, "msa_decode", msa)
    mp.setattr(dec_admm, "admm_decode", adm)


@pytest.mark.parametrize("fault", [fault_unchanged, fault_half_batch,
                                   fault_altered_answer],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(bench, name, fault,
                                                  monkeypatch):
    fault(monkeypatch)
    out, _ = tiny_run(bench, name)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_jax_loaded_by_the_window_ends_the_run(bench, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        tiny_run(bench, "ldpc1200_msa.deep")


class _NoWindow:
    """The traced window's interface with no profiler: a CPU run."""

    def open(self):
        pass

    def close(self):
        pass

    def ops(self):
        return []


def _jax_reader(monkeypatch):
    """Every per-layer metric read by a reader that imports (a stand-in
    for) JAX."""
    reader = types.ModuleType("reader")

    def read(ctx):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return None

    reader.read = read
    monkeypatch.setattr(spec, "metric_reader", lambda name: reader)


def _jax_reference(monkeypatch):
    """The reference imports (a stand-in for) the JAX package after the
    window has closed."""
    from portbench import check

    real = check.check

    def checked(*a, **kw):
        monkeypatch.setitem(sys.modules, "ldpc_decoders_tpu",
                            types.ModuleType("ldpc_decoders_tpu"))
        return real(*a, **kw)

    monkeypatch.setattr(check, "check", checked)


@pytest.mark.parametrize("late", [_jax_reader, _jax_reference],
                         ids=["reader", "reference"])
def test_jax_loaded_after_the_window_prints_no_result(bench, monkeypatch,
                                                      capsys, late):
    monkeypatch.setattr(trace, "Window", _NoWindow)
    late(monkeypatch)
    cell = spec.cell(bench, "ldpc1200_msa.deep")
    out, lines = run.run_cell(cell, 2 ** 33 + 5, 0.0, True, device="cpu",
                              overrides=TINY["ldpc1200_msa.deep"],
                              t_start=time.perf_counter())
    capsys.readouterr()
    with pytest.raises(SystemExit, match="jax|ldpc_decoders_tpu"):
        run.report(out, lines)
    assert capsys.readouterr().out == ""


def test_report_prints_the_checks_and_then_the_line(bench, capsys):
    out, lines = tiny_run(bench, "ldpc1200_msa.sweep")
    assert run.report(out, lines) == 0
    printed = capsys.readouterr()
    assert json.loads(printed.out.strip().splitlines()[-1]) == out
    assert printed.err.strip().splitlines()[-len(lines):] == lines


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ldpc_decoders_tpu_torch.x",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("y"))
    assert "ldpc_decoders_tpu" not in run.forbidden_modules()
    assert "jax" not in run.forbidden_modules()


def test_cli_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "ldpc1200_msa.deep", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def synthetic_context(ops, points):
    return trace.Context(
        ops=ops, t_open=0.0, t_close=10.0, points=points,
        config={"run_config": {"decoder": "MSA"}}, traffic={}, batch=100,
        graph={"n_var": 1200, "n_edge": 3600, "dc": 6},
        reference={"words": 1000, "iterations": 5000, "tail_words": 0,
                   "tail_iterations": 0},
        kernels={"msa_decode_kernel": "msa_decode.cu",
                 "transmit_kernel": "chunk.cu", "tally_kernel": "chunk.cu"})


def test_readers_on_a_synthetic_trace(bench):
    ops = [trace.Op("void msa_decode_kernel<6>(float*)", 1.0, 3.0),
           trace.Op("void transmit_kernel<0>(Args)", 0.5, 1.0),
           trace.Op("distribution_elementwise_grid_stride_kernel", 2.0, 4.0),
           trace.Op("ncclDevKernel_AllReduce", 6.0, 7.0)]
    points = [{"start": 0.0, "end": 5.0, "param": 3.0, "tot": 1000},
              {"start": 5.0, "end": 10.0, "param": 3.0, "tot": 1000}]
    ctx = synthetic_context(ops, points)
    assert ctx.busy() == pytest.approx(4.5)
    assert ctx.busy(0.0, 5.0) == pytest.approx(3.5)

    def read(name):
        return spec.metric_reader(name).read(ctx)

    assert read("device.idle_pct.cw") == pytest.approx(55.0)
    assert read("device.idle_pct.converge") == read("device.idle_pct.cw")
    assert read("torch_ops.ms_per_chunk.converge") == read(
        "torch_ops.ms_per_chunk")
    assert read("runner.host_ms_per_point") == pytest.approx(
        1e3 * ((5 - 3.5) + (5 - 1.0)) / 2)
    assert read("torch_ops.ms_per_chunk") == pytest.approx(1e3 * 2.0 / 20)
    assert read("runner.point_ms_p95") == pytest.approx(5e3)
    assert 0 < read("msa_decode.roofline_pct") < 100
    assert 0 < read("chunk.roofline_pct") < 100
    bd = trace.breakdown(ctx)
    assert bd["device_ops"][0][1] == pytest.approx(2.0)
    assert bd["idle_gaps"] == [["run_param 3.0", pytest.approx(3.0)],
                               ["run_param 3.0", pytest.approx(2.0)],
                               ["run_param 3.0", pytest.approx(0.5)]]
    assert len(bd["idle_gaps"]) <= 10


def test_the_window_reads_only_what_lies_between_its_markers(monkeypatch):
    """The profiler runs past each marker (``EDGE_S``), so the trace may
    hold operations outside them: none is read, and the rest are placed on
    the host's clock through the two markers."""
    w = trace.Window()
    w.marks = [100.0, 110.0]
    events = [("before", 900.0, 5.0), (trace.MARKER, 1000.0, 1.0),
              ("kernel", 4000.0, 2000.0), (trace.MARKER, 11000.0, 1.0),
              ("after", 11500.0, 5.0)]
    monkeypatch.setattr(w, "_device_events", lambda: events)
    ops = w.ops()
    assert [op.name for op in ops] == ["kernel"]
    assert ops[0].start == pytest.approx(103.0)
    assert ops[0].end == pytest.approx(105.0)


def test_readers_find_nothing_in_an_empty_trace(bench):
    ctx = synthetic_context([], [])
    for m in bench["per_layer"]:
        assert spec.metric_reader(m["name"]).read(ctx) is None
