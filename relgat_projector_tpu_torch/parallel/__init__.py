"""Multi-device training on ``torch.distributed``: the grid, the halo route
over the ``graph`` axis and data parallelism (port of
``relgat_projector_tpu/parallel``). Head tensor parallelism (``model``
axis) and the ``replicated`` and ``gspmd`` routes are not ported."""

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
from relgat_projector_tpu_torch.parallel.sharded import (  # noqa: F401
    all_reduce_grads,
    batch_vectors,
    broadcast_tree,
    place_graph,
    shard_batch_arrays,
)
