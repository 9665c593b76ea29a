"""The multi-shard tier: the shard mesh, the exchange and the mesh stage
programs (port of ``ballista_tpu/parallel``).

The reference's on-pod replacement for the network shuffle (IPC files
written by the shuffle writer, fetched over Flight by the reader): inside
one pod the exchange is a ``jax.lax.all_to_all`` over ICI inside one
jitted ``shard_map``. The port's mesh is N shards on one torch device, and
its exchange is one permutation of the shards' global layout on the card.

- ``mesh``: the mesh (``make_mesh``, ``BALLISTA_TPU_MESH_SHARDS``) and the
  block layout of a sharded batch;
- ``collective``: the bucketing and the exchange between shards;
- ``stage``: the mesh stages (repartitioned aggregate, partitioned join,
  top-k, sample sort, partition-keyed window);
- ``dryrun``: ``python -m ballista_tpu_torch.parallel.dryrun N``.
"""

from ballista_tpu_torch.parallel.mesh import (  # noqa: F401
    SHARD_AXIS,
    is_row_sharded,
    make_mesh,
    shard_batch,
    unshard_batch,
)
from ballista_tpu_torch.parallel.stage import MeshStageRunner  # noqa: F401
