"""Multi-rank execution (counterpart of ``ldpc_decoders_tpu.parallel``).

The reference parallelized at the shell: one process per experiment and
JSON files merged afterwards. Here one process runs per rank over
``torch.distributed``: codeword batches shard over a mesh's ``batch`` axis
and the tallies are summed over it, parity checks shard over its ``code``
axis (:class:`EdgeShardedBPDecoder`), and rank 0 owns the Saver.
"""

from ldpc_decoders_tpu_torch.parallel.bp_edge_sharded import (  # noqa: F401
    EdgeShardedBPDecoder,
)
from ldpc_decoders_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_mesh,
    code_mesh,
    initialize_distributed,
    is_coordinator,
    local_batch,
    spawn,
)
