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

With ``--trace 0`` the result line holds the cell's end-to-end metrics;
with ``--trace 1`` the window runs under a CUDA-only profiler and the line
holds its per-layer metrics, read from the trace by ``metrics/<name>.py``.
The last lines on standard error, and the result line's last key, give
each number compared beside its limit.

Exits non-zero with no result line where CUDA has fewer devices than the
cell's chips, where the program cannot be imported, or where JAX or the
JAX package is loaded when the window closes or when the result line is
about to be printed (after the reference and the readers).
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

from portbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ldpc_decoders_tpu")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton"}
# One process, few threads: the host's part of a point is one Python
# thread, and idle pool threads only contend with it.
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")
# Host-clock marks of set-up's parts before ``run_cell``, set by ``main``.
MARKS: dict = {}


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
    configuration) shrink a cell for the CPU tests."""
    import torch

    from portbench import check, trace as tr

    config, traffic = merged(cell, overrides or {})
    marks = dict(MARKS, harness=time.perf_counter())
    entry = spec.entry(config["entry"])
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        session = entry.open_session(config, traffic, seed, device, work)
        marks["session"] = time.perf_counter()
        session.warm_up()
        if device == "cuda":
            torch.cuda.synchronize()
        marks["warm_up"] = time.perf_counter()
        window = tr.Window() if trace else None
        if window:
            window.open()
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
            if b - t_open >= seconds:
                break
        t_close = b
        # set-up's parts: torch's import, CUDA's start (its devices
        # counted), the harness's modules, the program's import and its
        # runner, the warm-up chunk (its kernels' build or load included),
        # and in a traced run the profiler's start
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
            dev = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"],
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
        else:
            dev = {"platform": "cpu", "kind": "cpu", "count": 1,
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
                           saver_path)
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
    if trace:
        tables = check.load_tables(spec.ROOT, config, "cpu")
        ctx = tr.Context(
            ops=ops, t_open=t_open, t_close=t_close, points=points,
            config=config, traffic=traffic, batch=batch,
            graph={"n_var": tables.n_var, "n_edge": tables.n_edge,
                   "dc": int(tables.chk_var.shape[1])},
            reference=nums["reference"], kernels=tr.port_kernels(spec.ROOT))
        layer = {}
        for m in cell["per_layer"]:
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                layer[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = layer
        out["device"].update(busy_s=ctx.busy(), window_s=ctx.window_s)
        out["breakdown"] = tr.breakdown(ctx)
        out["traced_end_to_end"] = e2e
        phases["metrics"] = time.perf_counter() - t_metrics
    out["phases_s"] = phases
    out["points_checked"] = nums["points_checked"]
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
    cell = spec.cell(bench, args.workload)
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
