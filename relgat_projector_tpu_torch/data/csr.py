"""Compressed-row edge layout read by the Hopper propagate kernels.

This stands for ``relgat_projector_tpu/data/blocked.py``. The TPU kernels
walk ``[C, 8, TE]`` chunks of a block-padded stream because a TPU wants
static, (8, 128)-tiled blocks and turns scatters into one-hot matmuls. The
CUDA kernels gather and reduce rows directly, so they read plain CSR:

- by destination (forward): ``dst_ptr [N+1]``, ``src``/``dst``/``etype``
  and ``eid [E]`` in dst-sorted order. ``eid`` is an edge's canonical id,
  the key of the attention-dropout hash, the id the JAX layouts carry in
  ``chunk_meta`` row 3. For a whole graph it is the edge's position here,
  its index in ``GraphData``'s dst-sorted COO; a subset of a graph shard's
  edges (the halo route's local or remote sources, ``parallel/halo.py``)
  carries its position in the shard's whole edge list instead, so both
  routes draw the same masks;
- the forward's work plan: ``fwd_items [I, 4]``, one work item a row of
  ``(row, first edge, end edge, partial slot)``, in dst-CSR order. A row of
  at most ``FWD_ITEM_EDGES`` in-edges (rows without in-edges included) is
  one item, slot -1, and the kernel writes its output row directly. A
  longer row is cut into ``ceil(deg / FWD_ITEM_EDGES)`` consecutive
  chunks, each writing a partial (running max, sum, accumulator, bias sum)
  into its own slot; ``fwd_merge [S, 3]`` lists each such row with its
  slots ``[first, end)`` in chunk order for the merge kernel. So no row,
  however many in-edges it has, is one warp's serial walk;
- by source (backward): ``src_ptr [N_src+1]`` with ``by_src_dst``,
  ``by_src_etype`` and ``by_src_eid [E]``, each row's edges in dst-CSR order;
- the backward's work plan, the same rules over the src-CSR:
  ``bwd_items [J, 4]`` of ``(src row, first edge, end edge, partial slot)``
  and ``bwd_merge [T, 3]``, ``bwd_item_edges`` (``BWD_ITEM_EDGES``;
  ``with_bwd_plan`` rebuilds the plan at another size) edges an item at
  most. A row of at most that
  many out-edges (rows without out-edges included) is one item, slot -1,
  and the src pass writes its dh, W and B rows directly; a longer row's
  chunks write partial rows that ``relgat_bwd_src``'s merge adds in chunk
  order. So no source row, however many out-edges it has, is one warp's
  serial walk.

The source space may differ from the destination rows: ``num_nodes`` counts
the destination rows (of ``out`` and the statistics), ``num_src`` the rows of
``h`` that edges read (on one device both are the padded node count; a halo
shard's remote subset reads a received buffer of ``G * halo_pair`` rows).
Only the real edges are stored (as the JAX blocked path does); padded node
rows simply have empty ranges. All arrays are int32 on the kernels' device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Most edges of one forward work item: csrc/relgat_fwd.cu kItemEdges, the
# size of the kernel's shared-memory edge table.
FWD_ITEM_EDGES = 256
# Most edges of one src-pass work item. The src pass reads its edge table
# 32 or 16 edges at a time, so any size runs. On an H100 80GB HBM3 (700 W;
# src_plans.py, PERF.md section 6) 256 was within 3% of the best size on
# every graph timed where the sizes give different plans (out-degree hubs
# first or last in the source order; 8M edges on 100k nodes), in both
# passes; where every row fits one item (uniform or in-degree hubs at 1M
# edges) all sizes are one plan. Smaller items lose to their partial rows
# (32: up to 23%), larger ones to the tail of a hub's last chunks (1024:
# up to 10%). So the size is one constant, not a function of the graph's
# degrees.
BWD_ITEM_EDGES = 256


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    dst_ptr: torch.Tensor       # [N+1]
    src: torch.Tensor           # [E] dst-sorted
    dst: torch.Tensor           # [E] dst-sorted
    etype: torch.Tensor         # [E] dst-sorted
    eid: torch.Tensor           # [E] dst-sorted canonical edge ids
    src_ptr: torch.Tensor       # [N_src+1]
    by_src_dst: torch.Tensor    # [E] src-sorted
    by_src_etype: torch.Tensor  # [E] src-sorted
    by_src_eid: torch.Tensor    # [E] src-sorted
    fwd_items: torch.Tensor     # [I, 4] (row, e0, e1, slot or -1)
    fwd_merge: torch.Tensor     # [S, 3] (row, first slot, end slot)
    num_nodes: int              # destination rows
    num_edges: int
    num_rel: int                # relations the layout indexes (> max etype)
    fwd_item_edges: int         # the plan's most edges per item
    fwd_num_parts: int          # partial slots of the split rows
    num_src: int                # rows of the source space
    bwd_items: torch.Tensor     # [J, 4] (src row, e0, e1, slot or -1)
    bwd_merge: torch.Tensor     # [T, 3] (src row, first slot, end slot)
    bwd_item_edges: int         # the src pass's most edges per item
    bwd_num_parts: int          # partial slots of the split source rows

    @property
    def fwd_num_items(self) -> int:
        return int(self.fwd_items.shape[0])

    @property
    def fwd_num_split(self) -> int:
        return int(self.fwd_merge.shape[0])

    @property
    def bwd_num_items(self) -> int:
        return int(self.bwd_items.shape[0])

    @property
    def bwd_num_split(self) -> int:
        return int(self.bwd_merge.shape[0])


def _row_ptr(keys: np.ndarray, num_rows: int) -> np.ndarray:
    ptr = np.zeros(num_rows + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=num_rows), out=ptr[1:])
    return ptr


def _build_plan(ptr: np.ndarray, item_edges: int):
    """Work items ``[I, 4]`` and merge list ``[S, 3]`` (int64) over a CSR
    ``ptr``, ``item_edges`` edges an item at most."""
    if item_edges < 1:
        raise ValueError(f"item_edges must be positive, got {item_edges}")
    ptr = np.asarray(ptr, np.int64)
    deg = np.diff(ptr)
    chunks = np.maximum(1, -(-deg // item_edges))
    row = np.repeat(np.arange(deg.shape[0]), chunks)
    first = np.cumsum(chunks) - chunks         # each row's first item
    k = np.arange(row.shape[0]) - first[row]   # chunk index within the row
    e0 = ptr[row] + k * item_edges
    e1 = np.minimum(e0 + item_edges, ptr[row + 1])
    split = chunks[row] > 1
    slot = np.full(row.shape[0], -1, np.int64)
    slot[split] = np.arange(int(split.sum()))
    items = np.stack([row, e0, e1, slot], axis=1)
    split_rows = np.flatnonzero(chunks > 1)
    ends = np.cumsum(chunks[split_rows])
    merge = np.stack([split_rows, ends - chunks[split_rows], ends], axis=1)
    return items, merge.reshape(-1, 3)


def build_fwd_plan(dst_ptr: np.ndarray, item_edges: int):
    """The forward's work items ``[I, 4]`` and merge list ``[S, 3]`` (int64)
    over a dst-CSR ``dst_ptr``, ``item_edges`` edges an item at most."""
    return _build_plan(dst_ptr, item_edges)


def build_bwd_plan(src_ptr: np.ndarray, item_edges: int):
    """The src pass's work items ``[J, 4]`` of ``(src row, first edge, end
    edge, partial slot or -1)`` in src-CSR order and merge list ``[T, 3]``
    of ``(src row, first slot, end slot)`` (int64) over a src-CSR
    ``src_ptr``, ``item_edges`` edges an item at most."""
    return _build_plan(src_ptr, item_edges)


def _int32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def _bwd_fields(src_ptr: np.ndarray, item_edges: int, device) -> dict:
    items, merge = build_bwd_plan(src_ptr, item_edges)
    return dict(
        bwd_items=_int32(items, device), bwd_merge=_int32(merge, device),
        bwd_item_edges=int(item_edges),
        bwd_num_parts=int(merge[-1, 2]) if len(merge) else 0,
    )


def with_bwd_plan(csr: CSRGraph, item_edges: int) -> CSRGraph:
    """``csr`` with the src pass's work plan rebuilt at ``item_edges``
    edges an item at most (for timing item sizes, ``src_plans.py``, and
    for splitting rows at small sizes in tests)."""
    src_ptr = csr.src_ptr.cpu().numpy()
    return dataclasses.replace(
        csr, **_bwd_fields(src_ptr, item_edges, csr.src_ptr.device))


def build_csr_graph(
    src: np.ndarray,
    dst: np.ndarray,
    etype: np.ndarray,
    num_nodes: int,
    num_rel: int,
    device: torch.device,
    *,
    num_src: Optional[int] = None,
    eid: Optional[np.ndarray] = None,
) -> CSRGraph:
    """Build the two orderings and both work plans from real edges that are
    already sorted by dst (``data/graph.py`` sorts them stably),
    ``dst < num_nodes`` and ``src < num_src`` (default ``num_nodes``),
    checked here: on the card an index out of range is an illegal memory
    access. ``eid`` gives the edges' canonical ids (default: their
    positions)."""
    e = int(src.shape[0])
    if e >= 2**31:
        raise ValueError("the kernels index edges with int32")
    num_src = int(num_nodes if num_src is None else num_src)
    if e:
        for name, a, hi in (("src", src, num_src), ("dst", dst, num_nodes)):
            if a.min() < 0 or a.max() >= hi:
                raise ValueError(
                    f"{name} out of range: [{a.min()}, {a.max()}] not in "
                    f"[0, {hi})"
                )
    eid = np.arange(e) if eid is None else np.asarray(eid, np.int64)
    by_src = np.argsort(src, kind="stable")
    dst_ptr = _row_ptr(dst, num_nodes)
    src_ptr = _row_ptr(src, num_src)
    items, merge = build_fwd_plan(dst_ptr, FWD_ITEM_EDGES)

    def t(a):
        return _int32(a, device)

    return CSRGraph(
        dst_ptr=t(dst_ptr),
        src=t(src),
        dst=t(dst),
        etype=t(etype),
        eid=t(eid),
        src_ptr=t(src_ptr),
        by_src_dst=t(dst[by_src]),
        by_src_etype=t(etype[by_src]),
        by_src_eid=t(eid[by_src]),
        fwd_items=t(items),
        fwd_merge=t(merge),
        num_nodes=int(num_nodes),
        num_edges=e,
        num_rel=int(num_rel),
        fwd_item_edges=FWD_ITEM_EDGES,
        fwd_num_parts=int(merge[-1, 2]) if len(merge) else 0,
        num_src=num_src,
        **_bwd_fields(src_ptr, BWD_ITEM_EDGES, device),
    )
