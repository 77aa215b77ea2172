"""Sweep points through ``MonteCarloRunner.run_param``, the path that the
CLI (``main.py``) and ``campaign.py`` both end in.

Point ``i`` of a run at ``seed`` takes the ``i``-th parameter of the
traffic's list (cycling) and draws from the runner's own generator of
``(seed, i)``, so every point decodes fresh words. On a batch mesh
(``mesh``, one process per rank) the runner is the CLI's ``--mesh`` runner
and rank ``r`` of ``N`` draws from ``(seed, i, r, N)``. The configuration's
``run_config`` holds the ``RunConfig`` fields it sets; the traffic sets
``min_wec``, ``max_words`` and whether Saver files are written. Logs go,
as the CLI's do, to ``test.log`` in the run's work directory, and Saver
files beside it.
"""

from __future__ import annotations

import dataclasses
import logging
import os

from ldpc_decoders_tpu_torch.harness.runner import (
    MonteCarloRunner,
    RunConfig,
    point_generator,
)

# The warm-up point's index: no window reaches it.
WARM_UP_POINT = 2 ** 40


def configure_logging(workdir: str) -> None:
    """The CLI's file logging (``main.py`` without ``--console``)."""
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    logging.basicConfig(
        filename=os.path.join(workdir, "test.log"), filemode="a",
        format="%(asctime)s,%(msecs)03d|%(name)s|%(levelname)s|%(message)s",
        datefmt="%H:%M:%S", level=logging.INFO)


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 workdir: str, mesh=None):
        configure_logging(workdir)
        self.points = [float(p) for p in traffic["points"]]
        self.seed = int(seed)
        self.device = device
        cfg = RunConfig(
            **config["run_config"], params=self.points,
            min_wec=int(traffic["min_wec"]),
            max_words=traffic.get("max_words"), seed=self.seed,
            device=device,
            data_dir=(os.path.join(workdir, "data") if traffic.get("saver")
                      else None),
            cache_dir=os.path.join(workdir, "cache"))
        self.runner = MonteCarloRunner(cfg, mesh)
        self.rank = ((mesh.index("batch"), mesh.width("batch"))
                     if mesh is not None else ())
        self.batch = self.runner.local_batch
        self.track_hist = self.runner.track_hist
        self.saver_path = (self.runner.saver.file_path
                           if self.runner.saver else None)

    def param(self, i: int) -> float:
        return self.points[i % len(self.points)]

    def warm_up(self) -> None:
        """One chunk of the cell's decoder at its batch: the kernels build
        and load, the tables and the pinned copy path are made."""
        cfg = self.runner.cfg
        self.runner.cfg = dataclasses.replace(cfg, max_words=cfg.batch)
        try:
            self.run_point(WARM_UP_POINT)
        finally:
            self.runner.cfg = cfg

    def run_point(self, i: int) -> dict:
        param = self.param(i)
        gen = point_generator(self.runner.device, self.seed, i, *self.rank)
        res = self.runner.run_param(param, gen)
        out = {"param": param, "tot": res["tot"], "wec": res["wec"],
               "bec": res["bec"]}
        if self.track_hist:
            out["hist"] = list(res["dec"]["iter"]) if "dec" in res else None
        return out

    def close(self) -> None:
        self.runner = None


def open_session(config, traffic, seed, device, workdir, mesh=None) -> Session:
    return Session(config, traffic, seed, device, workdir, mesh)
