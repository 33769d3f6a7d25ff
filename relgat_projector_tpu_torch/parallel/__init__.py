"""Multi-device training on ``torch.distributed`` (port of
``relgat_projector_tpu/parallel``): the ``(data, graph, model)`` grid, the
halo route over the ``graph`` axis with head tensor parallelism over
``model``, the ``replicated`` and ``gspmd`` routes, and data parallelism.

The JAX package's exports and theirs here: ``make_mesh`` is ``make_grid``;
``place_graph``, ``shard_batch_arrays``, the halo plan's four names,
``initialize_distributed`` and ``is_primary`` keep their names;
``ShardedBlockedGraph``, ``shard_blocked_graph`` and
``place_sharded_blocked`` are ``ShardedCSRGraph``, ``shard_csr_graph`` and
``place_sharded_csr`` (CSR layouts), ``pallas_sharded_propagate`` keeps
its name; ``place_replicated`` is ``broadcast_tree`` (rank 0's state on
every rank); ``place_batch`` and ``place_scan_batch`` are
``shard_batch_arrays`` (every rank sees the batch whole and slices its
own); ``place_node_features`` is the trainer's
``dataset.feature_rows(*shard.row_range)``. The ``gspmd`` route, which
GSPMD partitions in JAX, is ``GspmdShard`` and ``gspmd_propagate``."""

from relgat_projector_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize_distributed,
    is_primary,
    process_count,
)
from relgat_projector_tpu_torch.parallel.halo import (  # noqa: F401
    HaloGraph,
    HaloShard,
    build_halo_graph,
    halo_propagate,
    halo_rows_per_shard,
    place_halo_graph,
    shard_seed,
)
from relgat_projector_tpu_torch.parallel.mesh import Grid, make_grid  # noqa: F401
from relgat_projector_tpu_torch.parallel.pallas_sharded import (  # noqa: F401
    ReplicatedShard,
    ShardedCSRGraph,
    pallas_sharded_propagate,
    place_sharded_csr,
    shard_csr_graph,
)
from relgat_projector_tpu_torch.parallel.sharded import (  # noqa: F401
    GspmdShard,
    all_reduce_grads,
    batch_vectors,
    broadcast_tree,
    gspmd_propagate,
    place_graph,
    shard_batch_arrays,
)
