"""The ``(data, graph, model)`` grid over the ranks of a process group.

Port of ``relgat_projector_tpu/parallel/mesh.py``. JAX lays a named device
mesh over one controller's devices and lets GSPMD place the collectives; here
each rank is one process with one device, and the grid names what a rank
holds and which ranks it talks to:

- ``data``  data parallelism over the triplet batch: a rank scores its
  slice of each batch;
- ``graph`` the destination rows of the message-passing graph, in
  contiguous ranges (``parallel/halo.py``): a rank holds one shard's rows
  and the edges into them, and exchanges boundary rows along its graph line;
- ``model`` tensor parallelism over attention heads, on the halo route: a
  rank computes its head range of every GAT layer over its shard's rows,
  and the ranks of a model line join their heads (``models/layer.py``).

Rank ``r`` sits at ``(d, g, m)`` with ``r = (d * G + g) * M + m``, the order
``mesh_utils.create_device_mesh`` gives a list of devices. A rank belongs to
one ``graph`` line (the ranks of its ``(d, m)``, in ``g`` order: the halo
exchange, the gather of the batch's rows, the join of the ``replicated``
route's rows and the merge of the ``gspmd`` route's partials), one ``data``
line (the ranks of its ``(g, m)``, in ``d`` order: the batch's slices), one
``model`` line when ``M > 1`` (the ranks of its ``(d, g)``, in ``m`` order:
the join of the heads) and the world (the sum of the gradients). Every
parameter and Adam moment is whole on every rank.

The collectives run on the process group's backend. Gloo has no collectives
on CUDA tensors, so on gloo a CUDA tensor goes through host memory and back
(``exchange_via`` says which way a grid's collectives go); NCCL takes them
on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    """One rank's place in a ``(data, graph, model)`` grid."""

    data: int
    graph: int
    model: int
    data_index: int
    graph_index: int
    graph_group: Any        # this rank's graph line, in graph order
    data_group: Any         # this rank's data line, in data order
    world_group: Any        # every rank of the process group
    backend: str
    model_index: int = 0
    model_group: Any = None  # this rank's model line, in model order (M > 1)

    @property
    def size(self) -> int:
        return self.data * self.graph * self.model

    @property
    def rank(self) -> int:
        """This rank's position in the grid, its rank in the process
        group."""
        return ((self.data_index * self.graph + self.graph_index)
                * self.model + self.model_index)

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def exchange_via(self, device: torch.device) -> str:
        """``"host"`` where this grid's collectives stage a device's tensors
        through host memory (gloo on CUDA), else ``"device"``."""
        return "host" if _staged(self.backend, device) else "device"


def grid_coords(rank: int, data: int, graph: int, model: int = 1):
    """``(d, g, m)`` of grid position ``rank``."""
    return (rank // (graph * model), (rank // model) % graph, rank % model)


def grid_lines(data: int, graph: int, model: int = 1):
    """Every line of the grid as lists of ranks, in the order ``make_grid``
    makes their groups: ``{"graph": [...], "data": [...]}``, and
    ``"model"`` when ``model > 1``. With ``model == 1`` the graph and data
    lines are those of a ``data`` x ``graph`` grid."""

    def rank(d, g, m):
        return (d * graph + g) * model + m

    lines = {
        "graph": [[rank(d, g, m) for g in range(graph)]
                  for d in range(data) for m in range(model)],
        "data": [[rank(d, g, m) for d in range(data)]
                 for g in range(graph) for m in range(model)],
    }
    if model > 1:
        lines["model"] = [[rank(d, g, m) for m in range(model)]
                          for d in range(data) for g in range(graph)]
    return lines


def make_grid(mesh_cfg) -> Grid:
    """The grid of ``mesh_cfg`` (a ``config.MeshConfig``) over the whole
    process group, which must hold exactly ``mesh_cfg.num_devices`` ranks.
    Every rank calls it: ``torch.distributed.new_group`` is collective."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a grid of several devices needs the process group: call "
            "parallel.initialize_distributed first"
        )
    data, graph, model = (mesh_cfg.data_axis, mesh_cfg.graph_axis,
                          mesh_cfg.model_axis)
    world = dist.get_world_size()
    if world != data * graph * model:
        raise ValueError(
            f"a grid of {data}x{graph}x{model} needs {data * graph * model} "
            f"ranks, the process group has {world}"
        )
    mine = dist.get_rank()
    made = {"model": None}
    for key, lines in grid_lines(data, graph, model).items():
        for line in lines:
            group = dist.new_group(line)
            if mine in line:
                made[key] = group
    d, g, m = grid_coords(mine, data, graph, model)
    return Grid(
        data=data, graph=graph, model=model, data_index=d, graph_index=g,
        graph_group=made["graph"], data_group=made["data"],
        world_group=dist.group.WORLD, backend=dist.get_backend(),
        model_index=m, model_group=made["model"],
    )


# ---------------------------------------------------------------------------
# Collectives; each stages CUDA tensors through host memory on gloo.
# ---------------------------------------------------------------------------

def _staged(backend: str, device: torch.device) -> bool:
    return backend == "gloo" and device.type == "cuda"


def _host(t: torch.Tensor, staged: bool) -> torch.Tensor:
    return t.cpu() if staged else t


def all_reduce_sum(t: torch.Tensor, group, backend: str) -> torch.Tensor:
    """The sum of ``t`` over ``group``, a new tensor."""
    staged = _staged(backend, t.device)
    buf = t.cpu() if staged else t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device) if staged else buf


def all_reduce_max(t: torch.Tensor, group, backend: str) -> torch.Tensor:
    """The elementwise max of ``t`` over ``group``, a new tensor."""
    staged = _staged(backend, t.device)
    buf = t.cpu() if staged else t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return buf.to(t.device) if staged else buf


def all_to_all(send: torch.Tensor, group, backend: str) -> torch.Tensor:
    """``recv[o] = send_o[me]`` over the ``group``'s ranks ``o``: chunk ``i``
    of ``send`` (its leading axis, one chunk a rank) goes to rank ``i``."""
    staged = _staged(backend, send.device)
    src = _host(send.contiguous(), staged)
    recv = torch.empty_like(src)
    dist.all_to_all_single(recv, src, group=group)
    return recv.to(send.device) if staged else recv


def all_gather_cat(t: torch.Tensor, group, backend: str,
                   dim: int = 0) -> torch.Tensor:
    """The ``group``'s ``t``, concatenated in rank order on axis ``dim``."""
    staged = _staged(backend, t.device)
    src = _host(t.contiguous(), staged)
    parts: List[torch.Tensor] = [torch.empty_like(src)
                                 for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.to(t.device) if staged else out


# ---------------------------------------------------------------------------
# The collectives autograd runs through. Every rank computes the global loss
# from its copies and takes the gradient of ``loss / ranks``; the gradients
# are summed over the world (``parallel/sharded.py``). So the transpose of a
# collective that gives every rank of a group the same value sums the
# cotangents of those copies over the group.
# ---------------------------------------------------------------------------

class _SumOverGroup(torch.autograd.Function):
    """The sum over a group; its transpose is the same sum."""

    @staticmethod
    def forward(ctx, t, group, backend):
        ctx.args = (group, backend)
        return all_reduce_sum(t, group, backend)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce_sum(g.contiguous(), *ctx.args),) + (None,) * 2


class _GatherBlocks(torch.autograd.Function):
    """The group's blocks joined on ``dim`` in rank order; the backward
    sums the cotangents over the group and keeps this rank's block."""

    @staticmethod
    def forward(ctx, t, group, index, backend, dim):
        ctx.args = (group, index, backend, dim, t.shape[dim])
        return all_gather_cat(t, group, backend, dim)

    @staticmethod
    def backward(ctx, g):
        group, index, backend, dim, size = ctx.args
        total = all_reduce_sum(g.contiguous(), group, backend)
        return (total.narrow(dim, index * size, size),) + (None,) * 4


def sum_over(t: torch.Tensor, group, backend: str) -> torch.Tensor:
    """The sum of ``t`` over ``group``, differentiable."""
    return _SumOverGroup.apply(t, group, backend)


def gather_blocks(t: torch.Tensor, group, index: int, backend: str,
                  dim: int = 0) -> torch.Tensor:
    """The ``group``'s ``t`` (this rank's block at position ``index``),
    joined on axis ``dim``, differentiable."""
    return _GatherBlocks.apply(t, group, index, backend, dim)


def broadcast_(t: torch.Tensor, src_rank: int, group, backend: str) -> None:
    """Overwrite ``t`` with global rank ``src_rank``'s ``t``."""
    staged = _staged(backend, t.device)
    buf = _host(t, staged)
    dist.broadcast(buf, src=src_rank, group=group)
    if staged:
        t.copy_(buf)


def barrier(grid: Grid) -> None:
    """Wait until every rank of the grid gets here."""
    dist.barrier(group=grid.world_group)
