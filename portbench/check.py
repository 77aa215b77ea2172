"""Whether the timed path's answers are right: a sample of the window's
points, drawn from the seed, replayed by the plain reference
(``reference/``) and compared with what the runner returned, number for
number; where the cell writes Saver files, every value the file holds for
the points that wrote it last.

On several ranks, every rank replays the same points, each its own stream
at its share of the batch, with the tallies summed over the ranks at each
consume (``reference/replay.py``); the sums are compared with the point's
summed tallies, which every rank holds.

Each number compared is a count of differences, with the limit 0:

- ``tally_diff``: |tot - tot'| + |wec - wec'| + |bec - bec'| summed over
  the points checked;
- ``hist_diff``: the iteration histograms' differences, summed over bins
  and points (where the program's decoder keeps one: its file in
  ``reference/decoders/`` says so);
- ``saver_diff``: the values of the Saver file (tot, wec, wer, bec, ber,
  and the histogram's average and bins where kept) that differ from the
  reference's, or are missing, over every parameter the window wrote.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from portbench import spec
from portbench.ranks import ONE, Ranks
from portbench.reference import codes, replay, seeding

LIMITS = {"tally_diff": 0, "hist_diff": 0, "saver_diff": 0}
SAMPLE_SALT = 0x5A3E
# Points of a window replayed, drawn from the seed (with, where the cell
# writes Saver files, each parameter's last point).
CHECK_POINTS = 1


def reference(config: dict):
    """The configuration's decoder in the plain reference: its
    ``reference/decoders/<decoder>.py``."""
    return spec.reference_decoder(config["run_config"]["decoder"])


def load_tables(root: str, config: dict, device):
    H = codes.load_parity(codes.code_path(root, config["run_config"]["code"]))
    return codes.tables(H, device)


def replay_point(config: dict, traffic: dict, tables, seed: int, idx: int,
                 param: float, device, precision: Optional[str] = None,
                 ranks: Ranks = ONE) -> dict:
    rc = config["run_config"]
    ref = reference(config)
    return replay.replay_point(
        channel=rc["channel"], codeword=rc["codeword"], param=param,
        batch=rc["batch"], n_var=tables.n_var,
        gen=seeding.point_generator(device, seed, idx, ranks.rank,
                                    ranks.size),
        decode=ref.decoder(rc, tables, precision),
        min_wec=int(traffic["min_wec"]), max_words=traffic.get("max_words"),
        pipeline=rc.get("pipeline", 4),
        adaptive=rc.get("adaptive_pipeline", True),
        track_hist=ref.TRACK_ITER_HIST,
        rank_batch=rc["batch"] // ranks.size,
        host_sum=ranks.sum if ranks.size > 1 else None)


def sample(points: list, seed: int, k: int) -> list:
    """``k`` of the window's points, drawn from the seed."""
    rng = np.random.default_rng([seed, SAMPLE_SALT])
    pick = rng.choice(len(points), size=min(k, len(points)), replace=False)
    return [points[j] for j in sorted(pick)]


def last_written(points: list) -> list:
    """For each parameter, the window's last point at it: what the Saver
    file holds."""
    last = {}
    for p in points:
        last[p["param"]] = p
    return list(last.values())


def diffs(got: dict, ref: dict) -> tuple:
    tally = sum(abs(int(got[k]) - int(ref[k])) for k in ("tot", "wec", "bec"))
    hist = 0
    if "hist" in ref:
        mine = (np.zeros_like(ref["hist"]) if got.get("hist") is None
                else np.asarray(got["hist"], dtype=np.int64))
        hist = int(np.abs(mine - ref["hist"]).sum())
    return tally, hist


def status(ref: dict, n_var: int) -> dict:
    """The values a Saver file holds for a point, as the runner states
    them (its ``status``), from the reference's tallies."""
    tot = ref["tot"]
    out = {"tot": tot, "wec": ref["wec"],
           "wer": ref["wec"] / tot if tot else 0.0, "bec": ref["bec"],
           "ber": ref["bec"] / (tot * n_var) if tot else 0.0}
    if "hist" in ref and ref["hist"].sum():
        h = ref["hist"]
        out["dec"] = {"average": float(h @ np.arange(h.size) / h.sum()),
                      "iter": h.tolist()}
    return out


def saver_diff(path: str, refs: dict, n_var: int) -> int:
    """Values of the Saver file that differ from the reference's, over the
    parameters in ``refs`` ({param: reference point})."""
    with open(path) as fp:
        saved = json.load(fp)
    bad = 0
    for param, ref in refs.items():
        for key, want in status(ref, n_var).items():
            have = saved.get(key, {}).get(str(param))
            bad += int(have != want)
    return bad


def check(points: list, config: dict, traffic: dict, seed: int, root: str,
          device, saver_path: Optional[str], ranks: Ranks = ONE) -> dict:
    """The numbers compared, each with its limit, and the reference's
    counts on the words it decoded (this rank's words, for the work
    counts). Every rank picks the same points; only the rank that holds
    the Saver file (``saver_path``) compares it."""
    tables = load_tables(root, config, device)
    picked = {p["idx"]: p for p in sample(points, seed, CHECK_POINTS)}
    if traffic.get("saver"):
        picked.update({p["idx"]: p for p in last_written(points)})
    refs, tally, hist, failed = {}, 0, 0, 0
    words = iters = 0
    tail_words = tail_iters = 0
    for idx, p in sorted(picked.items()):
        ref = replay_point(config, traffic, tables, seed, idx, p["param"],
                           device, ranks=ranks)
        refs[idx] = ref
        t, h = diffs(p, ref)
        tally, hist, failed = tally + t, hist + h, failed + int(t + h > 0)
        words += ref["chunks"] * config["run_config"]["batch"] // ranks.size
        iters += ref["iters_sum"]
        tail_words += ref.get("tail_words", 0)
        tail_iters += ref.get("tail_iters", 0)
    nums = {"points_checked": len(picked), "failed": failed,
            "checks": {"tally_diff": tally}}
    if reference(config).TRACK_ITER_HIST:
        nums["checks"]["hist_diff"] = hist
    if saver_path:
        nums["checks"]["saver_diff"] = saver_diff(
            saver_path, {p["param"]: refs[p["idx"]]
                         for p in last_written(points)}, tables.n_var)
    nums["reference"] = {"words": words, "iterations": iters,
                         "tail_words": tail_words, "tail_iterations": tail_iters}
    return nums
