"""The ``replicated`` route: the kernels on each rank's destination range,
with the node features replicated.

Port of ``relgat_projector_tpu/parallel/pallas_sharded.py``. The padded
node space is cut into contiguous destination ranges, one a graph shard;
the rank at graph index ``g`` holds one CSR layout (``data/csr.py``) of the
edges into its range:

- destination rows rebased to the range (``num_nodes`` = rows per shard);
- **global** source ids (``num_src`` = the padded node count), since every
  rank holds every row of ``h``;
- canonical edge ids = the edge's position in the dst-sorted edge list, the
  ids the one-device layout hashes. So with the same seed on every shard,
  the attention-dropout masks are one device's, bit for bit.

Forward: each rank runs the propagate kernels on its range, and the ranges
are joined over the graph line (JAX: ``out_specs P('graph')``). Backward:
the join's transpose sums the output's cotangents over the line and keeps
the rank's rows; the kernels then scatter ``dh`` over the whole source
space. JAX sums that ``dh`` over the graph axis (the transpose of the
replicated ``P()`` input); here each rank's ``dh`` reaches its own copy of
the weights and of the layer's input, and the sums happen where the copies
meet: the gradients' sum over the world, and the previous layer's join.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from relgat_projector_tpu_torch.data.csr import CSRGraph, build_csr_graph
from relgat_projector_tpu_torch.ops.segment import STABLE_SOFTMAX_EPS
from relgat_projector_tpu_torch.parallel.mesh import Grid, gather_blocks

# Destination rows of a shard are a multiple of this (the JAX package
# rounds to its TPU row blocks; the CSR layout takes any count).
ROW_MULTIPLE = 8


@dataclasses.dataclass(frozen=True)
class ShardedCSRGraph:
    """The host plan of every shard (JAX ``ShardedBlockedGraph``): the
    dst-sorted real edges, and shard ``g``'s as the range
    ``[edge_ptr[g], edge_ptr[g + 1])`` of them."""

    src: np.ndarray          # [E] int64, dst-sorted
    dst: np.ndarray          # [E] int64
    etype: np.ndarray        # [E] int64
    edge_ptr: np.ndarray     # [G + 1] int64
    num_shards: int
    rows_per_shard: int
    num_nodes: int           # the padded node count: the output's rows
    num_real_edges: int


def shard_csr_graph(
    src: np.ndarray,
    dst: np.ndarray,
    etype: np.ndarray,
    num_nodes: int,
    num_shards: int,
) -> ShardedCSRGraph:
    """The plan of real edges sorted by ``dst`` (``data/graph.py`` sorts
    them stably) over ``num_nodes`` padded rows in ``num_shards``
    contiguous ranges (JAX ``shard_blocked_graph``)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    etype = np.asarray(etype, np.int64)
    if np.any(np.diff(dst) < 0):
        raise ValueError("shard_csr_graph takes edges sorted by dst")
    g = int(num_shards)
    per = -(-int(num_nodes) // g)
    rows = -(-per // ROW_MULTIPLE) * ROW_MULTIPLE
    shard_of = np.minimum(dst // rows, g - 1)
    edge_ptr = np.searchsorted(shard_of, np.arange(g + 1), side="left")
    return ShardedCSRGraph(
        src=src, dst=dst, etype=etype, edge_ptr=edge_ptr.astype(np.int64),
        num_shards=g, rows_per_shard=rows, num_nodes=int(num_nodes),
        num_real_edges=int(src.shape[0]),
    )


@dataclasses.dataclass(frozen=True, eq=False)
class ReplicatedShard:
    """What the rank at graph index ``index`` holds of a
    ``ShardedCSRGraph``: the layout of the edges into its rows."""

    grid: Grid
    index: int
    num_shards: int
    rows: int
    num_nodes: int
    csr: CSRGraph

    @property
    def row_range(self):
        lo = self.index * self.rows
        return lo, lo + self.rows


def shard_csr_layout(plan: ShardedCSRGraph, g: int, num_rel: int,
                     device: torch.device) -> CSRGraph:
    """Shard ``g``'s layout on ``device``: its edges' destinations rebased
    to its range, global sources and ids."""
    rows = plan.rows_per_shard
    lo, hi = (int(x) for x in plan.edge_ptr[g:g + 2])
    return build_csr_graph(
        plan.src[lo:hi], plan.dst[lo:hi] - g * rows, plan.etype[lo:hi],
        rows, num_rel, device, num_src=plan.num_nodes,
        eid=np.arange(lo, hi),
    )


def place_sharded_csr(
    plan: ShardedCSRGraph,
    grid: Grid,
    num_rel: int,
    device: torch.device,
) -> ReplicatedShard:
    """The rank's layout of ``plan`` (graph index ``grid.graph_index``) on
    ``device`` (JAX ``place_sharded_blocked``)."""
    if grid.graph != plan.num_shards:
        raise ValueError(
            f"a plan of {plan.num_shards} shards on a grid with graph axis "
            f"{grid.graph}"
        )
    g = grid.graph_index
    return ReplicatedShard(
        grid=grid, index=g, num_shards=plan.num_shards,
        rows=plan.rows_per_shard, num_nodes=plan.num_nodes,
        csr=shard_csr_layout(plan, g, num_rel, device))


def pallas_sharded_propagate(
    h: torch.Tensor,               # [N_pad, H, F] every row (replicated)
    attn_bank: torch.Tensor,       # [H, R, F]
    rel_bias: Optional[torch.Tensor],
    shard: ReplicatedShard,
    *,
    negative_slope: float = 0.2,
    eps: float = STABLE_SOFTMAX_EPS,
    attn_dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    kernel_precision: str = "highest",
) -> torch.Tensor:
    """The aggregate ``[N_pad, H, F]`` on every rank of the graph line: the
    kernels over this rank's range, joined over the line. ``dropout_seed``
    is the layer's, the same on every shard."""
    if not isinstance(shard, ReplicatedShard):
        raise ValueError(
            "the graph holds the plan of every shard: place this rank's "
            "range with parallel.place_graph first"
        )
    from relgat_projector_tpu_torch.ops.propagate import (
        relgat_propagate_kernels,
    )

    if h.shape[0] != shard.num_nodes:
        raise ValueError(f"h has {h.shape[0]} rows, the graph "
                         f"{shard.num_nodes}")
    out = relgat_propagate_kernels(
        h, attn_bank, rel_bias, shard.csr, negative_slope=negative_slope,
        eps=eps, attn_dropout_rate=attn_dropout_rate,
        dropout_seed=dropout_seed, kernel_precision=kernel_precision,
    )
    grid = shard.grid
    full = gather_blocks(out, grid.graph_group, shard.index, grid.backend)
    return full[:shard.num_nodes]
