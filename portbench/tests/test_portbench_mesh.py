"""A cell on four ranks, tiny and on the CPU (four processes over gloo): a
well-formed line from rank 0, the check's summed replay following the
runner's stop, a traced run's readers on rank 0's share, and a comparison
that fails on each fault a four-rank cell can have, planted in the ranks
it names."""

import dataclasses
import json
import os
import time

import pytest

from portbench import run, spec, trace
from portbench.tests import test_portbench_run as one
from portbench.tests.conftest import TINY

NAME = "ldpc1200_msa_x4.deep16m"
# What a rank of a test run plants before it runs (``planted_rank``): a
# JSON {"plant": <name in PLANTS>, "ranks": [the ranks that plant it]}.
ENV = "PORTBENCH_TEST_PLANT"


def _mesh_class():
    from ldpc_decoders_tpu_torch.parallel.mesh import Mesh

    return Mesh


def plant_cpu_window(mp):
    """The traced window's interface with no profiler (a CPU run)."""
    mp.setattr(trace, "Window", one._NoWindow)


def plant_flip_one_chunk(mp):
    """The first chunk after the warm-up has one decision flipped where
    the decoder makes it."""
    from ldpc_decoders_tpu_torch.decoders import bp as dec_bp

    real, calls = dec_bp.msa_decode, []

    def msa(llr, t, **kw):
        x, it = real(llr, t, **kw)
        calls.append(1)
        return (one._flip(x), it) if len(calls) == 2 else (x, it)

    mp.setattr(dec_bp, "msa_decode", msa)


def plant_tally_left_out(mp):
    """This rank's chunk tallies are left out of the ranks' sum."""
    Mesh = _mesh_class()
    host_sum, all_reduce = Mesh.host_sum, Mesh.all_reduce

    def zeroed(real):
        def reduce(self, t, axis, *a, **kw):
            t.zero_()
            return real(self, t, axis, *a, **kw)
        return reduce

    mp.setattr(Mesh, "host_sum", zeroed(host_sum))
    mp.setattr(Mesh, "all_reduce", zeroed(all_reduce))


def plant_no_exchange(mp):
    """The tallies are not summed over the ranks: each rank counts its own
    words' errors as the whole batch's."""
    Mesh = _mesh_class()
    mp.setattr(Mesh, "host_sum", lambda self, t, axis: t)
    mp.setattr(Mesh, "all_reduce", lambda self, t, axis, op=None: t)


def plant_rank0_stream(mp):
    """This rank draws its words from rank 0's stream."""
    from ldpc_decoders_tpu_torch.harness import runner

    real = runner.point_generator

    def gen(device, seed, idx, rank=0, ranks=1):
        return real(device, seed, idx, 0, ranks)

    mp.setattr(runner, "point_generator", gen)


PLANTS = {"cpu_window": plant_cpu_window,
          "unchanged": one.fault_unchanged,
          "half_batch": one.fault_half_batch,
          "flip_one_chunk": plant_flip_one_chunk,
          "tally_left_out": plant_tally_left_out,
          "no_exchange": plant_no_exchange,
          "rank0_stream": plant_rank0_stream}


def planted_rank(*args):
    """``run.rank_cell`` with what ``ENV`` names planted in this rank."""
    import torch.distributed as dist

    mp = pytest.MonkeyPatch()
    want = json.loads(os.environ.get(ENV, "[]"))
    for plant in want:
        if dist.get_rank() in plant["ranks"]:
            PLANTS[plant["plant"]](mp)
    try:
        return run.rank_cell(*args)
    finally:
        mp.undo()


def mesh_run(bench, monkeypatch, plants=(), trace_=False, overrides=None,
             seed=2 ** 33 + 3):
    monkeypatch.setattr(run, "RANK_CELL",
                        "portbench.tests.test_portbench_mesh:planted_rank")
    monkeypatch.setenv(ENV, json.dumps([{"plant": p, "ranks": r}
                                        for p, r in plants]))
    tiny = json.loads(json.dumps(TINY[NAME]))
    for k, v in (overrides or {}).items():
        tiny.setdefault(k, {}).update(v)
    return run.run_cell(spec.cell(bench, NAME), seed, 0.0, trace_,
                        device="cpu", overrides=tiny,
                        t_start=time.perf_counter())


def test_a_sound_run_prints_rank_0s_line(bench, monkeypatch):
    out, lines = mesh_run(bench, monkeypatch)
    back = json.loads(json.dumps(out))
    assert list(back)[:5] == one.KEYS and list(back)[-1] == "checks"
    assert back["correct"] is True and back["failed"] == 0
    assert set(back["metrics"]) == {"cw_per_s.mesh", "setup_s"}
    assert all(m["value"] > 0 for m in back["metrics"].values())
    assert back["device"]["count"] == 4
    assert back["checks"] == {"tally_diff": {"value": 0, "limit": 0}}
    assert len(back["per_rank"]["memory_peak_bytes"]) == 4
    assert "phase setup.ranks" in " ".join(lines)
    assert lines[-1] == "check tally_diff: 0 (limit 0)"


def test_the_replay_follows_the_runners_stop_within_reach(bench,
                                                          monkeypatch):
    """``min_wec`` in reach of a few chunks: the runner stops on the summed
    tallies, in the adaptive pipeline's ramp, and the replay stops with
    it, tot for tot."""
    out, _ = mesh_run(bench, monkeypatch, overrides={
        "traffic": {"points": [2.5], "min_wec": 40,
                    "max_words": 64 * 100}})
    assert out["correct"] is True
    assert out["checks"]["tally_diff"]["value"] == 0
    words = out["metrics"]["cw_per_s.mesh"]["value"] * out["phases_s"][
        "window"]
    assert 64 * 2 <= round(words) < 64 * 100


def test_a_traced_run_reads_rank_0s_share(bench, monkeypatch):
    out, _ = mesh_run(bench, monkeypatch, plants=[("cpu_window", [0, 1, 2,
                                                                  3])],
                      trace_=True)
    assert out["correct"] is True
    assert set(out["per_rank"]) >= {"busy_s", "memory_peak_bytes"}
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    assert out["metrics"] == {}


@pytest.mark.parametrize("plant,ranks", [
    ("unchanged", [0, 1, 2, 3]), ("half_batch", [0, 1, 2, 3]),
    ("flip_one_chunk", [1]), ("tally_left_out", [3]),
    ("no_exchange", [0, 1, 2, 3]), ("rank0_stream", [2])])
def test_a_fault_on_a_rank_is_not_correct(bench, monkeypatch, plant, ranks):
    out, _ = mesh_run(bench, monkeypatch, plants=[(plant, ranks)])
    assert out["correct"] is False
    assert out["checks"]["tally_diff"]["value"] > 0


def test_rank_0s_words_set_the_readers_counts():
    ops = [trace.Op("void msa_decode_kernel<6>(float*)", 1.0, 3.0),
           trace.Op("ncclDevKernel_AllReduce_Sum_u64_RING_LL", 6.0, 7.0)]
    points = [{"start": 0.0, "end": 10.0, "param": 3.0, "tot": 4000}]
    ctx = one.synthetic_context(ops, points)
    mesh = dataclasses.replace(ctx, ranks=4)
    assert (ctx.words, ctx.chunks) == (4000, 40)
    assert (mesh.words, mesh.chunks) == (1000, 10)
    reader = spec.metric_reader("mesh.allreduce_ms_per_chunk")
    assert reader.read(mesh) == pytest.approx(1e3 * 1.0 / 10)
    roof = spec.metric_reader("msa_decode.roofline_pct.mesh")
    assert roof.read(mesh) == pytest.approx(roof.read(ctx) / 4)
