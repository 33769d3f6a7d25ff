"""Compressed-row edge layout read by the Hopper propagate kernels.

This stands for ``relgat_projector_tpu/data/blocked.py``. The TPU kernels
walk ``[C, 8, TE]`` chunks of a block-padded stream because a TPU wants
static, (8, 128)-tiled blocks and turns scatters into one-hot matmuls. The
CUDA kernels gather and reduce rows directly, so they read plain CSR:

- by destination (forward): ``dst_ptr [N+1]``, ``src``/``dst``/``etype [E]``
  in dst-sorted order. An edge's id, the key of the attention-dropout hash,
  is its position here, which is its index in ``GraphData``'s dst-sorted COO,
  the same id the JAX layouts carry in ``chunk_meta`` row 3;
- by source (backward, dh): ``src_ptr [N+1]`` with ``by_src_dst``,
  ``by_src_etype`` and ``by_src_eid [E]``;
- by relation (backward, dattn/dbias): edge ids sorted by relation, cut into
  chunks of at most ``REL_CHUNK_EDGES`` edges that never straddle two
  relations, with ``rel_chunk_ptr [R+1]`` indexing each relation's chunks.

Only the real edges are stored (as the JAX blocked path does); padded node
rows simply have empty ranges. All arrays are int32 on the kernels' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

REL_CHUNK_EDGES = 256


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    dst_ptr: torch.Tensor       # [N+1]
    src: torch.Tensor           # [E] dst-sorted
    dst: torch.Tensor           # [E] dst-sorted
    etype: torch.Tensor         # [E] dst-sorted
    src_ptr: torch.Tensor       # [N+1]
    by_src_dst: torch.Tensor    # [E] src-sorted
    by_src_etype: torch.Tensor  # [E] src-sorted
    by_src_eid: torch.Tensor    # [E] src-sorted
    rel_eid: torch.Tensor       # [E] relation-sorted edge ids
    chunk_start: torch.Tensor   # [C] into rel_eid
    chunk_end: torch.Tensor     # [C]
    rel_chunk_ptr: torch.Tensor  # [R+1] into the chunks
    num_nodes: int
    num_edges: int
    num_rel: int                # relations the layout indexes (> max etype)

    @property
    def num_chunks(self) -> int:
        return int(self.chunk_start.shape[0])


def _row_ptr(keys: np.ndarray, num_rows: int) -> np.ndarray:
    ptr = np.zeros(num_rows + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=num_rows), out=ptr[1:])
    return ptr


def build_csr_graph(
    src: np.ndarray,
    dst: np.ndarray,
    etype: np.ndarray,
    num_nodes: int,
    num_rel: int,
    device: torch.device,
) -> CSRGraph:
    """Build the three orderings from real edges that are already sorted by
    dst (``data/graph.py`` sorts them stably), bounds already checked."""
    e = int(src.shape[0])
    if e >= 2**31:
        raise ValueError("the kernels index edges with int32")
    dst_ptr = _row_ptr(dst, num_nodes)
    by_src = np.argsort(src, kind="stable")
    src_ptr = _row_ptr(src, num_nodes)
    rel_eid = np.argsort(etype, kind="stable")

    rel_counts = np.bincount(etype, minlength=num_rel)
    chunks_per_rel = -(-rel_counts // REL_CHUNK_EDGES)
    rel_chunk_ptr = np.zeros(num_rel + 1, np.int64)
    np.cumsum(chunks_per_rel, out=rel_chunk_ptr[1:])
    rel_start = np.concatenate([[0], np.cumsum(rel_counts)[:-1]])
    chunk_rel = np.repeat(np.arange(num_rel), chunks_per_rel)
    chunk_idx = np.arange(int(rel_chunk_ptr[-1])) - rel_chunk_ptr[chunk_rel]
    chunk_start = rel_start[chunk_rel] + chunk_idx * REL_CHUNK_EDGES
    chunk_end = np.minimum(
        chunk_start + REL_CHUNK_EDGES, rel_start[chunk_rel] + rel_counts[chunk_rel]
    )

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return CSRGraph(
        dst_ptr=t(dst_ptr),
        src=t(src),
        dst=t(dst),
        etype=t(etype),
        src_ptr=t(src_ptr),
        by_src_dst=t(dst[by_src]),
        by_src_etype=t(etype[by_src]),
        by_src_eid=t(by_src),
        rel_eid=t(rel_eid),
        chunk_start=t(chunk_start),
        chunk_end=t(chunk_end),
        rel_chunk_ptr=t(rel_chunk_ptr),
        num_nodes=int(num_nodes),
        num_edges=e,
        num_rel=int(num_rel),
    )
