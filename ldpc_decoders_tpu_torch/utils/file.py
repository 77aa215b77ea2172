"""File and label helpers of the harness, the CLI and the plots
(counterpart of ``ldpc_decoders_tpu.utils.file``)."""

from __future__ import annotations

import json
import os
import re
from collections import Counter, OrderedDict


def resolve_data_dir_os(project: str) -> str:
    """Default scratch root: $SCRATCH/<project> or ~/scratch/<project>."""
    root = os.environ.get("SCRATCH", os.path.join(os.path.expanduser("~"),
                                                  "scratch"))
    return os.path.join(root, project)


def bind_filter_args(parser):
    """--and / --or_ substring filters over file names."""
    parser.add_argument("--and", dest="and_", nargs="+", default=None,
                        help="keep names containing ALL of these substrings")
    parser.add_argument("--or_", nargs="+", default=None,
                        help="keep names containing ANY of these substrings")
    return parser


def filter_strings(args, names):
    names = list(names)
    and_ = getattr(args, "and_", None)
    or_ = getattr(args, "or_", None)
    if and_:
        names = [n for n in names if all(s in n for s in and_)]
    if or_:
        names = [n for n in names if any(s in n for s in or_)]
    return names


def naturalkey(text: str):
    """Sort key treating digit runs as numbers ('x2' < 'x10')."""
    return [int(t) if t.isdigit() else t.lower()
            for t in re.split(r"(\d+)", str(text))]


def gen_unique_labels(names, tokens=("_", "__", "-", ".json")):
    """Shortest distinguishing labels: drop tokens shared by ALL names.

    Splits each name on the token set and removes each token only as many
    times as it appears in EVERY name (multiset intersection), so
    'MSA-1-100-10' vs 'MSA-1-100-100' keeps one '100' for the second name
    instead of deleting its distinguishing field entirely."""
    pattern = "|".join(re.escape(t) for t in
                       sorted(set(tokens), key=len, reverse=True))
    split = [tuple(t for t in re.split(pattern, n) if t) for n in names]
    if not split:
        return []
    common = Counter(split[0])
    for s in split[1:]:
        common &= Counter(s)
    labels = []
    for s in split:
        drop = Counter(common)
        kept = []
        for t in s:
            if drop[t] > 0:
                drop[t] -= 1
            else:
                kept.append(t)
        labels.append("-".join(kept) if kept else "-".join(s))
    return labels


def get_data_file_list(data_dir: str) -> tuple:
    """The JSON result files in a directory (not its subdirectories)."""
    return tuple(f for f in next(os.walk(data_dir), ((), (), ()))[2]
                 if os.path.splitext(f)[1] == ".json")


def load_json(file_path: str):
    """Tolerant JSON load, None on any failure."""
    try:
        with open(file_path, "r") as fp:
            return json.load(fp, object_pairs_hook=OrderedDict)
    except (OSError, ValueError):
        return None


def make_dir_if_not_exists(dir_path: str) -> None:
    os.makedirs(dir_path, exist_ok=True)
