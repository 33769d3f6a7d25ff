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
- ``place_graph`` keeps a rank's shard of the graph.

Autograd: the loss on every rank is the global one, and each rank takes the
gradient of ``loss / world``. ``gather_data``'s backward sums its
cotangents over the data line and keeps this rank's slice;
``gather_rows``' backward sums them over the graph line (an all-reduce is
its own transpose) and scatters each owner's rows into its own. So the
gradients summed over the world are those of the single-device loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from relgat_projector_tpu_torch.parallel.halo import place_halo_graph
from relgat_projector_tpu_torch.parallel.mesh import (
    Grid,
    all_gather_cat,
    all_reduce_sum,
    broadcast_,
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


class _SumOverGroup(torch.autograd.Function):
    """The sum over a group; its transpose is the same sum."""

    @staticmethod
    def forward(ctx, t, group, backend):
        ctx.args = (group, backend)
        return all_reduce_sum(t, group, backend)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce_sum(g.contiguous(), *ctx.args),) + (None,) * 2


class _GatherData(torch.autograd.Function):
    """The data line's tensors in data order; the backward sums the
    cotangents over the line and keeps this rank's block."""

    @staticmethod
    def forward(ctx, t, grid: Grid):
        ctx.grid, ctx.rows = grid, t.shape[0]
        return all_gather_cat(t, grid.data_group, grid.backend)

    @staticmethod
    def backward(ctx, g):
        grid, rows = ctx.grid, ctx.rows
        total = all_reduce_sum(g.contiguous(), grid.data_group, grid.backend)
        return total[grid.data_index * rows:(grid.data_index + 1) * rows], None


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
    return _SumOverGroup.apply(part, grid.graph_group, grid.backend)


def gather_data(t: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The data slices' ``t`` joined in data order (axis 0)."""
    if grid.data == 1:
        return t
    return _GatherData.apply(t, grid)


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


def place_graph(graph, grid: Grid, num_rel: int, *, csr: bool):
    """``graph`` as the rank of ``grid`` holds it: its shard of the halo plan
    (``parallel.halo``), with the kernels' layouts if ``csr``; a graph
    without a plan is held whole."""
    if graph.halo is None:
        return graph
    shard = place_halo_graph(graph.halo, grid, num_rel, graph.src.device,
                             csr=csr)
    return dataclasses.replace(graph, halo=shard)
