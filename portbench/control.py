"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in the nearest precision
below the configuration's, compared with the reference as a run compares
the program. Each of the cell's numbers must come out above its limit on
some number for the control to fail, as it has to. The precision, and the
reason for it, is the decoder's file's (``reference/decoders/``).

    python3 -m portbench.control --workload <name> --seeds 1,2,3

runs on the card at the cell's own sizes (a point each seed, or a whole
sweep's points with Saver values) and prints one JSON line per seed; the
benchmark's own runs never run it. A cell on several ranks replays each
rank's stream in a process of its own, the tallies summed over gloo, as a
run's check does; the ranks take a card each where there are enough, and
share one otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from portbench import check, spec
from portbench.ranks import ONE, Ranks


def control_numbers(cell: dict, seed: int, device: str,
                    overrides: dict = None) -> dict:
    """The cell's numbers with the control in the program's place: the
    point (or, where the cell writes Saver files, one point of each
    parameter) that a run at ``seed`` would check first."""
    if cell["chips"] == 1:
        return _numbers(cell, seed, device, overrides, ONE)
    from ldpc_decoders_tpu_torch.parallel import mesh

    return mesh.spawn("portbench.control:rank_numbers", cell["chips"],
                      (cell, seed, device, overrides), device=device,
                      backend="gloo")[0]


def rank_numbers(cell: dict, seed: int, device: str,
                 overrides: dict) -> dict:
    """``control_numbers`` on one rank of ``mesh.spawn``'s group."""
    return _numbers(cell, seed, device, overrides, Ranks.joined())


def _numbers(cell: dict, seed: int, device: str, overrides: dict,
             ranks: Ranks) -> dict:
    from portbench.run import merged

    config, traffic = merged(cell, overrides or {})
    tables = check.load_tables(spec.ROOT, config, device)
    ref_decoder = check.reference(config)
    low = ref_decoder.control_precision(config["run_config"])
    n = len(traffic["points"])
    rng = np.random.default_rng([seed, check.SAMPLE_SALT])
    first = int(rng.integers(0, 16 * n))
    idxs = ([first - first % n + j for j in range(n)] if traffic.get("saver")
            else [first])
    tally = hist = saved = 0
    for idx in idxs:
        param = traffic["points"][idx % n]
        ref = check.replay_point(config, traffic, tables, seed, idx, param,
                                 device, ranks=ranks)
        got = check.replay_point(config, traffic, tables, seed, idx, param,
                                 device, precision=low, ranks=ranks)
        t, h = check.diffs(got, ref)
        tally, hist = tally + t, hist + h
        want, have = (check.status(r, tables.n_var) for r in (ref, got))
        saved += sum(int(have.get(k) != v) for k, v in want.items())
    nums = {"tally_diff": tally}
    if ref_decoder.TRACK_ITER_HIST:
        nums["hist_diff"] = hist
    if traffic.get("saver"):
        nums["saver_diff"] = saved
    return {"seed": seed, "points": idxs, "precision": low, "numbers": nums,
            "fails": any(v > check.LIMITS[k] for k, v in nums.items())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the comparison's control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    cell = spec.cell(spec.benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = control_numbers(cell, seed, "cuda")
        print(json.dumps(dict(out, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
