"""File helpers the harness and CLI need (counterpart of
``ldpc_decoders_tpu.utils.file``)."""

from __future__ import annotations

import json
import os
from collections import OrderedDict


def resolve_data_dir_os(project: str) -> str:
    """Default scratch root: $SCRATCH/<project> or ~/scratch/<project>."""
    root = os.environ.get("SCRATCH", os.path.join(os.path.expanduser("~"),
                                                  "scratch"))
    return os.path.join(root, project)


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
