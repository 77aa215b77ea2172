"""``Saver.add`` (``ldpc_decoders_tpu_torch/harness/saver.py``) timed on
the host beside the form it replaced, in turns in one process, on files
under ``TMPDIR``.

    python scripts/profile_saver.py [--adds 3000] [--rounds 2]

The old form reloads the file, merges one parameter's values and rewrites
the whole document with ``json.dump(..., indent=4)`` through a temp file
and a rename; ``Saver.add`` writes the same bytes from the document it
holds. Two documents, each sweep's 16 parameters (0.5 to 3.0 dB) cycled:

- ``msa``: the runner's six status values a parameter (``tot``, ``wec``,
  ``wer``, ``bec``, ``ber``, ``words_per_sec``), as the min-sum sweep
  writes them;
- ``admm``: the same plus ``dec`` (``average`` and the 2000-bin ``iter``
  histogram), as an ADMM sweep writes them; a tenth of ``--adds``, as the
  old form takes tens of ms an add on this document.

Each round times the adds of each form in turns (old, new, new, old),
each add by ``time.perf_counter`` with no recorder on, and checks after
every add that both files hold the same bytes. A last pass of as many
adds runs ``Saver.add`` with the recorder on
(``utils/profiler.py``) and gives the ``saver.write`` share of the
``saver`` span and the ``saver_reloads`` count (1: only the first add
reads the file). Prints, per document and form, the median and p99 ms per
add, and the file system ``TMPDIR`` is on.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import random
import statistics
import sys
import tempfile
import time
from collections import OrderedDict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ldpc_decoders_tpu_torch.harness.saver import Saver  # noqa: E402
from ldpc_decoders_tpu_torch.utils import profiler  # noqa: E402
from ldpc_decoders_tpu_torch.utils.file import load_json  # noqa: E402

POINTS = [0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0, 2.2, 2.3, 2.4, 2.5, 2.6,
          2.7, 2.8, 2.9, 3.0]
RUN_IDS = {
    "msa": [("channel", "biawgn"), ("code", "1200_3_6"), ("decoder", "MSA"),
            ("codeword", 1), ("min_wec", 100), ("max_iter", 10),
            ("dtype", "bfloat16")],
    "admm": [("channel", "bsc"), ("code", "margulis"), ("decoder", "ADMM"),
             ("codeword", 1), ("min_wec", 100), ("mu", 3.0), ("eps", 1e-05),
             ("max_iter", 8000), ("presort", False)],
}


class OldSaver:
    """The form ``Saver.add`` replaced: reload, merge, dump, rename."""

    def __init__(self, data_dir: str, run_ids):
        self.dict = OrderedDict(run_ids)
        os.makedirs(data_dir, exist_ok=True)
        file_name = "-".join(str(v) for v in self.dict.values())
        self.file_path = os.path.join(data_dir, f"{file_name}.json")

    def add(self, param, val_dict) -> None:
        data = load_json(self.file_path)
        if data is None:
            data = OrderedDict(self.dict)
            for key in val_dict:
                data[key] = {}
        for key in val_dict:
            data.setdefault(key, {})[str(param)] = val_dict[key]
        tmp_path = self.file_path + ".tmp"
        with open(tmp_path, "w") as fp:
            json.dump(data, fp, indent=4)
        os.replace(tmp_path, self.file_path)


def status(rng: random.Random, doc: str) -> OrderedDict:
    """One point's values as ``MonteCarloRunner``'s ``status`` gives them."""
    tot = 16384 * rng.randint(1, 64)
    wec = rng.randint(100, 400)
    bec = wec * rng.randint(5, 60)
    vals = OrderedDict([("tot", tot), ("wec", wec), ("wer", wec / tot),
                        ("bec", bec), ("ber", bec / (tot * 1200))])
    if doc == "admm":
        hist = [0] * 2000
        for _ in range(200):
            hist[min(1999, int(rng.expovariate(1 / 40)))] += tot // 200
        avg = sum(i * n for i, n in enumerate(hist)) / sum(hist)
        vals["dec"] = {"average": avg, "iter": hist}
    vals["words_per_sec"] = tot / rng.uniform(0.001, 0.01)
    return vals


def run(old, new, doc: str, adds: int, seed: int) -> tuple:
    """``adds`` adds of each, in turns by add; (old ms, new ms) lists."""
    rng = random.Random(seed)
    t_old, t_new = [], []
    for i in range(adds):
        param, vals = POINTS[i % len(POINTS)], status(rng, doc)
        order = ((old, t_old), (new, t_new))
        for saver, times in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            saver.add(param, vals)
            times.append(1e3 * (time.perf_counter() - t0))
        with open(old.file_path, "rb") as a, open(new.file_path, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{doc}: files differ after add {i}")
    return t_old, t_new


def traced(new, doc: str, adds: int, seed: int) -> tuple:
    """(saver.write share of saver, saver_reloads) over ``adds`` adds."""
    rng = random.Random(seed)
    rec = profiler.enable()
    try:
        for i in range(adds):
            new.add(POINTS[i % len(POINTS)], status(rng, doc))
    finally:
        profiler.disable()
    ms = {}
    for s in map(profiler.Span._make, rec.spans):
        ms[s.name] = ms.get(s.name, 0.0) + s.end - s.start
    return ms["saver.write"] / ms["saver"], rec.counters.get("saver_reloads")


def quantiles(ms: list) -> str:
    p99 = statistics.quantiles(ms, n=100)[98]
    return f"median {statistics.median(ms):.4f} ms, p99 {p99:.4f} ms"


def file_system(path: str) -> str:
    """The type of the mount that holds ``path`` (from /proc/mounts)."""
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as fp:
            for line in fp:
                dev, mnt, fs = line.split()[:3]
                if path.startswith(mnt) and len(mnt) > len(best):
                    best, kind = mnt, f"{fs} on {mnt}"
    except OSError:
        pass
    return kind


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--adds", type=int, default=3000)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    tmp = tempfile.gettempdir()
    print(f"host {platform.node()}, {platform.processor() or 'cpu'}, "
          f"{os.cpu_count()} cores, Python {platform.python_version()}, "
          f"TMPDIR {tmp} ({file_system(os.path.realpath(tmp))})")
    for doc, ids in RUN_IDS.items():
        n = args.adds if doc == "msa" else max(16, args.adds // 10)
        t_old, t_new = [], []
        for r in range(args.rounds):
            with tempfile.TemporaryDirectory() as d:
                old = OldSaver(os.path.join(d, "old"), ids)
                new = Saver(os.path.join(d, "new"), ids)
                a, b = run(old, new, doc, n, seed=r)
                t_old += a
                t_new += b
        with tempfile.TemporaryDirectory() as d:
            share, reloads = traced(Saver(d, ids), doc, n, seed=args.rounds)
        print(f"{doc}: {args.rounds} x {n} adds, files equal after every "
              f"add")
        print(f"  old (reload, merge, json.dump, rename): {quantiles(t_old)}")
        print(f"  Saver.add: {quantiles(t_new)}; saver.write "
              f"{100 * share:.1f}% of saver, saver_reloads {reloads}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
