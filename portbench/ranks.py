"""A run's ranks as the harness sees them: which one this process is, how
many there are, and the few exchanges the harness makes between them on
a gloo group of its own, apart from the program's groups:

- ``agree``: rank 0's decision (the window closes after this point) on
  every rank, so all ranks stop after the same point;
- ``barrier``: the ranks meet before the window opens;
- ``sum``: a host array summed over the ranks (the reference's tallies,
  at each consume of a replayed point, as the runner sums its own);
- ``gather``: one number of each rank, on every rank, in rank order.

``ONE`` is a run in one process: nothing is exchanged."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


class Ranks:
    def __init__(self, rank: int = 0, size: int = 1, group=None):
        self.rank, self.size, self.group = rank, size, group

    @classmethod
    def joined(cls) -> "Ranks":
        """This process's place in the process group it has joined, with a
        new gloo group over all of it (every rank makes it, in the same
        order among its groups)."""
        group = dist.new_group(backend="gloo")
        return cls(dist.get_rank(), dist.get_world_size(), group)

    def agree(self, flag: bool) -> bool:
        if self.size == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int64)
        dist.broadcast(t, src=0, group=self.group)
        return bool(t[0])

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)

    def sum(self, arr: np.ndarray) -> np.ndarray:
        if self.size == 1:
            return arr
        t = torch.from_numpy(np.array(arr, dtype=np.int64))
        dist.all_reduce(t, group=self.group)
        return t.numpy()

    def gather(self, value: float) -> list:
        if self.size == 1:
            return [value]
        parts = [torch.zeros(1, dtype=torch.float64)
                 for _ in range(self.size)]
        dist.all_gather(parts, torch.tensor([float(value)],
                                            dtype=torch.float64),
                        group=self.group)
        return [float(p[0]) for p in parts]


ONE = Ranks()
