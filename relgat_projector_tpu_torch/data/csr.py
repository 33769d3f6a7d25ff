"""Compressed-row edge layout read by the Hopper propagate kernels.

This stands for ``relgat_projector_tpu/data/blocked.py``. The TPU kernels
walk ``[C, 8, TE]`` chunks of a block-padded stream because a TPU wants
static, (8, 128)-tiled blocks and turns scatters into one-hot matmuls. The
CUDA kernels gather and reduce rows directly, so they read plain CSR:

- by destination (forward): ``dst_ptr [N+1]``, ``src``/``dst``/``etype [E]``
  in dst-sorted order. An edge's id, the key of the attention-dropout hash,
  is its position here, which is its index in ``GraphData``'s dst-sorted COO,
  the same id the JAX layouts carry in ``chunk_meta`` row 3;
- by source (backward): ``src_ptr [N+1]`` with ``by_src_dst``,
  ``by_src_etype`` and ``by_src_eid [E]``, each row's edges in id order.

Only the real edges are stored (as the JAX blocked path does); padded node
rows simply have empty ranges. All arrays are int32 on the kernels' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
    num_nodes: int
    num_edges: int
    num_rel: int                # relations the layout indexes (> max etype)


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
    """Build the two orderings from real edges that are already sorted by
    dst (``data/graph.py`` sorts them stably), bounds already checked."""
    e = int(src.shape[0])
    if e >= 2**31:
        raise ValueError("the kernels index edges with int32")
    by_src = np.argsort(src, kind="stable")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return CSRGraph(
        dst_ptr=t(_row_ptr(dst, num_nodes)),
        src=t(src),
        dst=t(dst),
        etype=t(etype),
        src_ptr=t(_row_ptr(src, num_nodes)),
        by_src_dst=t(dst[by_src]),
        by_src_etype=t(etype[by_src]),
        by_src_eid=t(by_src),
        num_nodes=int(num_nodes),
        num_edges=e,
        num_rel=int(num_rel),
    )
