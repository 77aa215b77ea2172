"""Crash-safe incremental JSON result persistence (counterpart of
``ldpc_decoders_tpu.harness.saver``; same schema and file name).

The file is named by the joined run-id values; every ``add`` reloads the
existing JSON, merges the new per-parameter values and rewrites it through
a temp file and a rename, so a killed run keeps every completed log tick."""

from __future__ import annotations

import json
import os
from collections import OrderedDict

from ldpc_decoders_tpu_torch.utils import profiler
from ldpc_decoders_tpu_torch.utils.file import load_json, make_dir_if_not_exists


class Saver:
    def __init__(self, data_dir: str, run_ids):
        self.dict = OrderedDict(run_ids)
        make_dir_if_not_exists(data_dir)
        file_name = "-".join(str(v) for v in self.dict.values())
        self.file_path = os.path.join(data_dir, f"{file_name}.json")

    def add(self, param, val_dict) -> None:
        with profiler.span("saver"):
            data = load_json(self.file_path)
            if data is None:
                data = OrderedDict(self.dict)
                for key in val_dict:
                    data[key] = {}
            for key in val_dict:
                data.setdefault(key, {})[str(param)] = val_dict[key]
            self._write(data)

    def add_all(self, val_dict) -> None:
        """Rewrite the file as the run ids plus ``val_dict`` (the LT CLI's
        whole ``arr`` after every batch)."""
        data = OrderedDict(self.dict)
        data.update(val_dict)
        self._write(data)

    def _write(self, data) -> None:
        tmp_path = self.file_path + ".tmp"
        with open(tmp_path, "w") as fp:
            json.dump(data, fp, indent=4)
        os.replace(tmp_path, self.file_path)
