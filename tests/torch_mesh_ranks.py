"""Rank functions of ``tests/test_torch_mesh.py`` beyond those of
``ldpc_decoders_tpu_torch.parallel.jobs``. The spawned ranks import this
module by name (``"torch_mesh_ranks:function"``), so it imports nothing of
JAX."""

from ldpc_decoders_tpu_torch.parallel import jobs
from ldpc_decoders_tpu_torch.parallel.mesh import batch_mesh


def harness_summed_at_dispatch(**kw) -> dict:
    """``jobs.harness`` on a batch mesh of the world's ranks whose chunk
    tallies are summed through the main group when the chunk is dispatched
    (the design NCCL meshes take), whatever the backend."""
    mesh = batch_mesh()
    mesh.device_tally = True
    return jobs.harness(mesh=mesh, **kw)
