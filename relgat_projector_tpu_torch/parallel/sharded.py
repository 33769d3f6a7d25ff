"""What a rank holds of a batch and of the state, and the collectives of
the step on the grid.

Port of ``relgat_projector_tpu/parallel/sharded.py``. In JAX the placement
is declarative (batches ``P('data')``, node features ``P('graph')``, state
replicated) and GSPMD inserts the collectives; here each is explicit:

- a batch is split over ``data`` (``shard_batch_arrays``), padded with
  zero-weight rows when ``data`` does not divide it; a scanned ``[S, B]``
  batch is split step by step, as each step slices its own;
- the head and scorer read the rows of the batch's endpoints, which live on
  their owners: ``gather_rows`` fetches them along the graph line, an
  all-reduce of each owner's rows in a buffer of the requested rows, a few
  thousand rows a step rather than the GAT output;
- ``gather_data`` joins the data slices' rows, so every rank computes the
  loss over the global batch with the single-device code (the mean over
  the global batch, the self-adversarial and padding weights included);
- ``all_reduce_grads`` sums the gradients over the world before Adam, so
  every rank takes the same step from the same global gradient;
- ``broadcast_tree`` gives every rank rank 0's initial state;
- ``place_graph`` keeps a rank's part of the graph: its halo shard, its
  destination range on the ``replicated`` route (``pallas_sharded.py``),
  or its piece of the edge list on the ``gspmd`` route;
- ``gspmd_propagate`` is that route's propagate (JAX leaves it to GSPMD's
  partial sums of ``[N, ...]`` over edge shards): each rank runs the plain
  partial propagate over its contiguous piece of the padded dst-sorted
  edges into every row, and the pieces' softmax states merge over the
  graph line (``relgat_ops.merge_partial_states`` is the form of one
  rank). Dropout hashes each edge's global position, so the masks are
  one device's. It has no kernel form, as in JAX.

Autograd: the loss on every rank is the global one, and each rank takes the
gradient of ``loss / world``. ``gather_data``'s backward sums its
cotangents over the data line and keeps this rank's slice;
``gather_rows``' backward sums them over the graph line (an all-reduce is
its own transpose) and scatters each owner's rows into its own; the
joins of the ``replicated`` route's rows and of head tensor parallelism's
heads sum them over their line and keep the rank's block, and the
``gspmd`` merge's sum is its own transpose. So the gradients summed over
the world are those of the single-device loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from relgat_projector_tpu_torch.ops.segment import STABLE_SOFTMAX_EPS
from relgat_projector_tpu_torch.parallel.halo import place_halo_graph
from relgat_projector_tpu_torch.parallel.mesh import (
    Grid,
    all_reduce_max,
    all_reduce_sum,
    broadcast_,
    gather_blocks,
    sum_over,
)
from relgat_projector_tpu_torch.parallel.pallas_sharded import (
    ShardedCSRGraph,
    place_sharded_csr,
)
from relgat_projector_tpu_torch.utils.tree import tree_leaves, tree_map


def _data_slice(b: int, grid: Grid) -> Tuple[int, int, int]:
    """``(padded size, first row, rows)`` of this rank's slice of a batch
    of ``b`` rows."""
    per = -(-b // grid.data)
    return per * grid.data, grid.data_index * per, per


def shard_batch_arrays(grid: Grid, *arrays):
    """This rank's slice of batch arrays over ``data`` (axis 0), each padded
    with zeros (zero weight, so padded rows count nowhere) to a multiple of
    the data axis."""
    out = []
    for a in arrays:
        b = a.shape[0]
        padded, lo, per = _data_slice(b, grid)
        if padded != b:
            a = torch.cat([a, a.new_zeros((padded - b,) + a.shape[1:])])
        out.append(a[lo:lo + per])
    return tuple(out) if len(out) > 1 else out[0]


def gather_rows(x: torch.Tensor, idx: torch.Tensor, grid: Optional[Grid],
                halo=None) -> torch.Tensor:
    """Rows ``idx`` (global node ids) of the node representations, where
    this rank holds ``x``: all rows (no ``halo``), or its shard's rows, the
    others on the ranks of its graph line."""
    if halo is None:
        return x[idx]
    lo, hi = halo.row_range
    mine = (idx >= lo) & (idx < hi)
    local = torch.where(mine, idx - lo, 0)
    part = x[local] * mine[:, None].to(x.dtype)
    return sum_over(part, grid.graph_group, grid.backend)


def gather_data(t: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The data slices' ``t`` joined in data order (axis 0)."""
    if grid.data == 1:
        return t
    return gather_blocks(t, grid.data_group, grid.data_index, grid.backend)


def batch_vectors(
    x: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    neg_dst: torch.Tensor,
    grid: Optional[Grid],
    halo=None,
    *,
    split_data: bool = True,
):
    """``(x[src], x[dst], x[neg_dst])`` of a global batch ``[B]`` /
    ``[B, K]`` on every rank of a grid. ``split_data``: each rank fetches
    the rows of its data slice only (training), and the slices are joined;
    else every rank fetches the whole batch's (evaluation)."""
    if grid is None:
        return x[src], x[dst], x[neg_dst]
    b, k = neg_dst.shape
    split = split_data and grid.data > 1
    if split:
        src, dst, neg_dst = shard_batch_arrays(grid, src, dst, neg_dst)
    per = src.shape[0]
    idx = torch.cat([src, dst, neg_dst.reshape(-1)])
    rows = gather_rows(x, idx, grid, halo)            # [per * (2 + K), D]
    width = rows.shape[-1]
    if split:
        rows = gather_data(rows, grid).view(grid.data, per * (2 + k), width)
    else:
        rows = rows.view(1, per * (2 + k), width)
    src_v = rows[:, :per].reshape(-1, width)[:b]
    dst_v = rows[:, per:2 * per].reshape(-1, width)[:b]
    neg_v = rows[:, 2 * per:].reshape(-1, k, width)[:b]
    return src_v, dst_v, neg_v


def all_reduce_grads(grads: Any, grid: Grid) -> Any:
    """The gradient tree summed over the world, in one fp32 buffer, each
    leaf back in its own type."""
    leaves = tree_leaves(grads)
    flat = torch.cat([g.reshape(-1).float() for g in leaves])
    flat = all_reduce_sum(flat, grid.world_group, grid.backend)
    out, pos = [], 0
    for g in leaves:
        out.append(flat[pos:pos + g.numel()].view(g.shape).to(g.dtype))
        pos += g.numel()
    it = iter(out)
    return tree_map(lambda _: next(it), grads)


def broadcast_tree(tree: Any, grid: Grid) -> Any:
    """Every leaf of ``tree`` overwritten in place with rank 0's; returns
    the tree."""
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            broadcast_(t, 0, grid.world_group, grid.backend)
    return tree


@dataclasses.dataclass(frozen=True, eq=False)
class GspmdShard:
    """The rank's piece of the padded dst-sorted COO on the ``gspmd``
    route: ``eid`` are the edges' global positions, ``num_nodes`` the
    padded node count (every row is an output row)."""

    grid: Grid
    src: torch.Tensor
    dst: torch.Tensor
    etype: torch.Tensor
    eid: torch.Tensor
    num_nodes: int


def gspmd_pieces(num_edges: int, num_shards: int):
    """``[(first, end), ...]``: the contiguous equal pieces of ``num_edges``
    edges, one a graph shard (the last may be shorter)."""
    per = -(-num_edges // num_shards)
    return [(min(g * per, num_edges), min((g + 1) * per, num_edges))
            for g in range(num_shards)]


def place_graph(graph, grid: Grid, num_rel: int, *, csr: bool):
    """``graph`` as the rank of ``grid`` holds it: its shard of the halo plan
    (``parallel.halo``), with the kernels' layouts if ``csr``; its range of
    the ``replicated`` route's plan; else, over a graph axis, its piece of
    the edge list (the ``gspmd`` route, plain only). A graph without a
    plan on a grid without a graph axis is held whole."""
    if graph.halo is not None:
        shard = place_halo_graph(graph.halo, grid, num_rel,
                                 graph.src.device, csr=csr)
        return dataclasses.replace(graph, halo=shard)
    if isinstance(graph.edge_shard, ShardedCSRGraph):
        shard = place_sharded_csr(graph.edge_shard, grid, num_rel,
                                  graph.src.device)
        return dataclasses.replace(graph, edge_shard=shard)
    if grid.graph == 1:
        return graph
    if csr:
        raise ValueError(
            "the kernels over a graph axis need the halo or replicated "
            "route's plan (build_graph with halo_shards or graph_shards)"
        )
    lo, hi = gspmd_pieces(graph.num_edges_padded,
                          grid.graph)[grid.graph_index]
    shard = GspmdShard(
        grid=grid, src=graph.src[lo:hi], dst=graph.dst[lo:hi],
        etype=graph.etype[lo:hi],
        eid=torch.arange(lo, hi, device=graph.src.device),
        num_nodes=graph.num_nodes,
    )
    return dataclasses.replace(graph, edge_shard=shard)


def gspmd_propagate(
    h: torch.Tensor,               # [N_pad, H, F] every row (replicated)
    attn_bank: torch.Tensor,       # [H, R, F]
    rel_bias: Optional[torch.Tensor],
    shard: GspmdShard,
    *,
    negative_slope: float = 0.2,
    eps: float = STABLE_SOFTMAX_EPS,
    attn_dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """The aggregate ``[N_pad, H, F]`` on every rank of the graph line:
    this rank's partial state over its piece, merged over the line (the
    max of ``m``; then ``l``, ``acc`` and the bias sum rescaled to it and
    summed, in one collective)."""
    from relgat_projector_tpu_torch.ops.relgat_ops import (
        relgat_propagate_partial,
    )

    rate = attn_dropout_rate if dropout_seed is not None else 0.0
    acc, m, l, bias = relgat_propagate_partial(
        h, attn_bank, rel_bias, shard.src, shard.dst, shard.etype,
        num_out=shard.num_nodes, negative_slope=negative_slope,
        attn_dropout_rate=rate, dropout_seed=dropout_seed,
        dropout_edge_ids=shard.eid,
    )
    grid = shard.grid
    m_all = all_reduce_max(m, grid.graph_group, grid.backend)
    m_fin = torch.where(torch.isfinite(m_all), m_all, 0.0)
    scale = torch.where(torch.isfinite(m), torch.exp(m - m_fin), 0.0)
    parts = (acc * scale[..., None], l * scale, bias)
    total = sum_over(torch.cat([p.reshape(-1) for p in parts]),
                     grid.graph_group, grid.backend)
    acc_t, l_t, bias_t = (t.view_as(p) for t, p in zip(
        total.split([p.numel() for p in parts]), parts))
    out = acc_t / l_t.clamp_min(eps)[..., None]
    return out + bias_t[:, None, None]
