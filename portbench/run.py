"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as the
cell asks for. The cell's entry (``entries/``) builds the program's runner
and warms up the cell's shapes: that is the set-up. Then sweep points run
back to back, point ``i`` drawing from the runner's seeding of (seed, i);
the window opens at the first point and closes at the end of the first
point that ends after ``--seconds``. After it, a sample of the points is
replayed by the plain reference and compared (``check.py``).

A cell on several chips runs one process per rank, each on its own card,
started as the CLI's ``--mesh`` starts its ranks; each rank runs the
cell's runner on a batch mesh over all of them. The window is rank 0's
host clock, and all ranks stop after the same point. Every rank replays
the checked points on its own stream; a traced run traces every rank,
and the per-layer metrics read rank 0's trace. Rank 0's result is the one
printed, by this process.

With ``--trace 0`` the result line holds the cell's end-to-end metrics;
with ``--trace 1`` the window runs under a CUDA-only profiler and the line
holds its per-layer metrics, read from the trace by ``metrics/<name>.py``.
The last lines on standard error, and the result line's last key, give
each number compared beside its limit.

Exits non-zero with no result line where the cell's decoder has no plain
reference (``reference/decoders/<decoder>.py``; exit code 1, before
set-up), where CUDA has fewer devices than the cell's chips, where the
program cannot be imported, where a rank fails,
or where JAX or the JAX package is loaded when the window closes (in any
rank) or when the result line is about to be printed (after the reference
and the readers).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Optional  # noqa: E402

from portbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ldpc_decoders_tpu")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton"}
# One process, few threads: the host's part of a point is one Python
# thread, and idle pool threads only contend with it.
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")
# Host-clock marks of set-up's parts before ``run_cell``, set by ``main``.
MARKS: dict = {}
# What each rank of a cell on several runs (``run_ranks``).
RANK_CELL = "portbench.run:rank_cell"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_forbidden(when: str) -> None:
    loaded = forbidden_modules()
    if loaded:
        raise SystemExit(f"modules loaded {when} that the port must not "
                         f"load: {', '.join(loaded)}")


def merged(cell: dict, overrides: dict) -> tuple:
    config = json.loads(json.dumps(cell["config"]))
    traffic = dict(cell["traffic"], **overrides.get("traffic", {}))
    config["run_config"].update(overrides.get("run_config", {}))
    config.update({k: v for k, v in overrides.items()
                   if k not in ("traffic", "run_config")})
    return config, traffic


def end_to_end(metrics: list, points: list, t_open: float, t_close: float,
               setup_s: float) -> dict:
    """The cell's end-to-end metrics, by the name before the first dot:
    ``cw_per_s`` (all the words decoded over the window's wall time),
    ``ms_per_point`` (the window's wall time over its points), ``setup_s``
    (process start to the window's open)."""
    wall = t_close - t_open
    values = {"cw_per_s": sum(p["tot"] for p in points) / wall,
              "ms_per_point": 1e3 * wall / len(points),
              "setup_s": setup_s}
    return {m["name"]: {"value": values[m["name"].split(".")[0]],
                        "unit": m["unit"]} for m in metrics}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict = None,
             t_start: float = T_START) -> tuple:
    """One run of ``cell``: (result line as a dict, stderr check lines).
    ``overrides`` (``run_config``, ``traffic`` and top-level keys of the
    configuration) shrink a cell for the CPU tests. A cell on one chip
    runs in this process; on several, in one process per rank
    (``run_ranks``)."""
    if cell["chips"] > 1:
        return run_ranks(cell, seed, seconds, trace, device, overrides,
                         t_start)
    return _run(cell, seed, seconds, trace, device, overrides, t_start,
                dict(MARKS))


def run_ranks(cell: dict, seed: int, seconds: float, trace: bool,
              device: str, overrides: Optional[dict],
              t_start: float) -> tuple:
    """A cell on ``chips`` ranks, one process and one card each, started
    as the CLI's ``--mesh`` starts its ranks (the program's
    ``parallel.mesh.spawn``, over the configuration's backend): rank 0's
    (result line, check lines). A rank that fails ends the run."""
    from ldpc_decoders_tpu_torch.parallel import mesh

    config, _ = merged(cell, overrides or {})
    args = (cell, seed, seconds, trace, device, overrides, t_start,
            dict(MARKS))
    return mesh.spawn(RANK_CELL, cell["chips"], args, device=device,
                      backend=config.get("backend"))[0]


def rank_cell(cell: dict, seed: int, seconds: float, trace: bool,
              device: str, overrides: Optional[dict], t_start: float,
              marks: dict) -> Optional[tuple]:
    """One rank of ``run_ranks``, in the process group ``spawn`` joined:
    the cell's runner on a batch mesh over all the ranks. Rank 0 returns
    the run's (result line, check lines), the others None."""
    import torch

    from ldpc_decoders_tpu_torch.parallel import mesh
    from portbench.ranks import Ranks

    marks = dict(marks, ranks=time.perf_counter())
    torch.set_num_threads(1)
    grid = mesh.batch_mesh(cell["chips"])
    ranks = Ranks.joined()
    out = _run(cell, seed, seconds, trace, device, overrides, t_start, marks,
               ranks, grid)
    refuse_forbidden("by the end of the run")
    return out if ranks.rank == 0 else None


def _run(cell: dict, seed: int, seconds: float, trace: bool, device: str,
         overrides: Optional[dict], t_start: float, marks: dict,
         ranks=None, mesh=None) -> tuple:
    """The run of ``run_cell`` in this process, as one rank of ``ranks``
    on ``mesh`` where the cell runs on several. The window is rank 0's: it
    opens once every rank has warmed up, and after each point rank 0 says
    whether it closes, so every rank stops after the same point."""
    import torch

    from portbench import check, trace as tr
    from portbench.ranks import ONE

    ranks = ranks or ONE
    config, traffic = merged(cell, overrides or {})
    marks = dict(marks, harness=time.perf_counter())
    entry = spec.entry(config["entry"])
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        session = entry.open_session(config, traffic, seed, device, work,
                                     **({} if mesh is None
                                        else {"mesh": mesh}))
        marks["session"] = time.perf_counter()
        session.warm_up()
        if device == "cuda":
            torch.cuda.synchronize()
        marks["warm_up"] = time.perf_counter()
        window = tr.Window() if trace else None
        if window:
            window.open()
        ranks.barrier()
        points = []
        t_open = time.perf_counter()
        setup_s = t_open - t_start
        i = 0
        while True:
            a = time.perf_counter()
            res = session.run_point(i)
            b = time.perf_counter()
            points.append(dict(res, idx=i, start=a, end=b))
            i += 1
            if ranks.agree(b - t_open >= seconds):
                break
        t_close = b
        # set-up's parts: torch's import, CUDA's start (its devices
        # counted), on several ranks the ranks' start (each its own
        # process, torch's import and the process group), the harness's
        # modules, the program's import and its runner, the warm-up chunk
        # (its kernels' build or load included), and in a traced run the
        # profiler's start
        if window:
            marks["profiler"] = t_open
        phases = {"setup": setup_s}
        last = t_start
        for k, t in marks.items():
            phases[f"setup.{k}"] = t - last
            last = t
        phases["window"] = t_close - t_open
        ops = []
        if window:
            window.close()
            phases["trace_stop"] = time.perf_counter() - t_close
            ops = window.ops()
            phases["trace_read"] = (time.perf_counter() - t_close
                                    - phases["trace_stop"])
        refuse_forbidden("by the window's close")
        if device == "cuda":
            peaks = ranks.gather(torch.cuda.max_memory_allocated())
            dev = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(),
                   "count": cell["chips"],
                   "memory_peak_bytes": int(max(peaks))}
        else:
            peaks = [0] * ranks.size
            dev = {"platform": "cpu", "kind": "cpu", "count": ranks.size,
                   "memory_peak_bytes": 0}
        batch = session.batch
        saver_path = session.saver_path
        session.close()
        del session
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        nums = check.check(points, config, traffic, seed, spec.ROOT, device,
                           saver_path, ranks)
        phases["reference"] = time.perf_counter() - t_ref
    finally:
        shutil.rmtree(work, ignore_errors=True)
    checks = {k: {"value": v, "limit": check.LIMITS[k]}
              for k, v in nums["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    e2e = end_to_end(cell["end_to_end"], points, t_open, t_close, setup_s)
    t_metrics = time.perf_counter()
    out = {"correct": correct, "attempted": len(points),
           "failed": nums["failed"], "metrics": e2e, "device": dev}
    per_rank = {"memory_peak_bytes": [int(p) for p in peaks]}
    if trace:
        tables = check.load_tables(spec.ROOT, config, "cpu")
        ctx = tr.Context(
            ops=ops, t_open=t_open, t_close=t_close, points=points,
            config=config, traffic=traffic, batch=batch,
            graph={"n_var": tables.n_var, "n_edge": tables.n_edge,
                   "dc": int(tables.chk_var.shape[1])},
            reference=nums["reference"], kernels=tr.port_kernels(spec.ROOT),
            ranks=ranks.size)
        layer = {}
        for m in cell["per_layer"]:
            value = spec.metric_reader(m["name"]).read(ctx)
            per_rank[m["name"]] = [None if v != v else v for v in
                                   ranks.gather(float("nan") if value is None
                                                else value)]
            if value is not None:
                layer[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = layer
        busy = ranks.gather(ctx.busy())
        per_rank["busy_s"] = busy
        out["device"].update(busy_s=sum(busy) / len(busy),
                             window_s=ctx.window_s)
        out["breakdown"] = tr.breakdown(ctx)
        out["traced_end_to_end"] = e2e
        phases["metrics"] = time.perf_counter() - t_metrics
    out["phases_s"] = phases
    out["points_checked"] = nums["points_checked"]
    if ranks.size > 1:
        out["per_rank"] = per_rank
    out["checks"] = checks
    lines = [f"phase {k}: {v:.3f} s" for k, v in phases.items()]
    lines += [f"check {k}: {c['value']} (limit {c['limit']})"
              for k, c in checks.items()]
    return out, lines


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(spec.ROOT, ".bench_cache", sub)
    for var in THREAD_VARS:
        os.environ[var] = "1"
    bench = spec.benchmark()
    try:
        cell = spec.cell(bench, args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"refused: {e.args[0]}", file=sys.stderr)
        return 1
    import torch

    MARKS["torch"] = time.perf_counter()
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    MARKS["cuda"] = time.perf_counter()
    return report(*run_cell(cell, args.seed, args.seconds, bool(args.trace)))


def report(out: dict, lines: list) -> int:
    """Prints the check lines and then the result line, unless JAX or the
    JAX package has been loaded by now: by the reference, a reader or
    anything else that ran after the window."""
    refuse_forbidden("by the end of the run")
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
