"""Graph container: dst-sorted, padded COO plus the kernels' CSR layout.

Port of ``relgat_projector_tpu/data/graph.py``. The COO keeps the JAX
package's padding so the plain path matches ``_xla_propagate`` row for row:
nodes pad to ``round_up(N + 1, 8)`` with at least one padded row, edges pad
to a multiple of 128, and padded edges point ``src = dst`` at the last
padded row with ``etype = 0``.

``halo_shards > 0`` builds the halo route's plan instead of the kernels'
layout (``parallel/halo.py``): nodes pad to ``halo_shards * rows_per_shard``
and ``halo`` holds the host plan of every shard, which
``parallel.place_halo_graph`` turns into one rank's shard (a one-shard plan
carries head tensor parallelism without a graph axis). ``graph_shards > 1``
with ``csr`` builds the ``replicated`` route's plan instead
(``parallel/pallas_sharded.py``): the one-device padding, and
``edge_shard`` holds the destination ranges, which ``parallel.place_graph``
turns into one rank's layout.

Unlike the JAX path's clip-mode gathers, an out-of-range index on the card is
an illegal memory access, so ``build_graph`` checks every index on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from relgat_projector_tpu_torch.data.csr import CSRGraph, build_csr_graph
from relgat_projector_tpu_torch.device import DeviceLike, resolve_device


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class GraphData:
    src: torch.Tensor    # [E_pad] int64
    dst: torch.Tensor    # [E_pad] int64, non-decreasing
    etype: torch.Tensor  # [E_pad] int64
    num_nodes: int       # padded
    num_real_nodes: int
    num_real_edges: int
    max_etype: int       # -1 without edges
    csr: Optional[CSRGraph] = None  # the kernels' layout (use_pallas)
    halo: Any = None     # HaloGraph (host plan) or one rank's HaloShard
    # The routes with replicated features: ShardedCSRGraph (the replicated
    # route's host plan) or one rank's ReplicatedShard or GspmdShard.
    edge_shard: Any = None

    @property
    def num_edges_padded(self) -> int:
        return int(self.src.shape[0])


def build_graph(
    src: np.ndarray,
    dst: np.ndarray,
    etype: np.ndarray,
    num_nodes: int,
    *,
    num_rel: Optional[int] = None,
    csr: bool = False,
    edge_pad_multiple: int = 128,
    node_pad_multiple: int = 8,
    graph_shards: int = 1,
    halo_shards: int = 0,
    halo_overlap: bool = False,
    device: DeviceLike = "cuda",
) -> GraphData:
    """Build a padded, dst-sorted :class:`GraphData` from host COO arrays.

    ``csr=True`` adds the CSR layout the propagate kernels read (the
    counterpart of ``blocked=True``). ``num_rel`` bounds ``etype`` when
    given; the layout then covers that many relations. ``halo_shards > 0``
    builds the halo plan (with the local/remote split if
    ``halo_overlap``), and ``graph_shards > 1`` with ``csr`` the
    replicated route's plan, in place of the layout; the shards build
    theirs."""
    dev = resolve_device(device)
    src = np.asarray(src).astype(np.int64).reshape(-1)
    dst = np.asarray(dst).astype(np.int64).reshape(-1)
    etype = np.asarray(etype).astype(np.int64).reshape(-1)
    num_real_edges = int(src.shape[0])
    num_real_nodes = int(num_nodes)
    if not (dst.shape[0] == etype.shape[0] == num_real_edges):
        raise ValueError("src, dst and etype must have the same length")
    if num_real_edges:
        for name, a, hi in (("src", src, num_real_nodes),
                            ("dst", dst, num_real_nodes),
                            ("etype", etype, num_rel)):
            if a.min() < 0 or (hi is not None and a.max() >= hi):
                raise ValueError(
                    f"{name} out of range: [{a.min()}, {a.max()}] not in "
                    f"[0, {hi})"
                )
    max_etype = int(etype.max()) if num_real_edges else -1

    order = np.argsort(dst, kind="stable")
    src, dst, etype = src[order], dst[order], etype[order]

    plan = None
    if halo_shards > 0:
        from relgat_projector_tpu_torch.parallel.halo import build_halo_graph

        plan = build_halo_graph(src, dst, etype, num_real_nodes, halo_shards,
                                overlap=halo_overlap)
        num_nodes_padded = plan.num_nodes
    else:
        num_nodes_padded = round_up(num_real_nodes + 1, node_pad_multiple)
    e_pad = round_up(max(num_real_edges, 1), edge_pad_multiple)
    pad_n = e_pad - num_real_edges
    pad_node = num_nodes_padded - 1
    src_p = np.concatenate([src, np.full(pad_n, pad_node, np.int64)])
    dst_p = np.concatenate([dst, np.full(pad_n, pad_node, np.int64)])
    et_p = np.concatenate([etype, np.zeros(pad_n, np.int64)])

    layout = sharded = None
    if csr and plan is None and graph_shards > 1:
        from relgat_projector_tpu_torch.parallel.pallas_sharded import (
            shard_csr_graph,
        )

        sharded = shard_csr_graph(src, dst, etype, num_nodes_padded,
                                  graph_shards)
    elif csr and plan is None:
        layout = build_csr_graph(
            src, dst, etype, num_nodes_padded,
            num_rel if num_rel is not None else max_etype + 1, dev,
        )
    return GraphData(
        src=torch.from_numpy(src_p).to(dev),
        dst=torch.from_numpy(dst_p).to(dev),
        etype=torch.from_numpy(et_p).to(dev),
        num_nodes=num_nodes_padded,
        num_real_nodes=num_real_nodes,
        num_real_edges=num_real_edges,
        max_etype=max_etype,
        csr=layout,
        halo=plan,
        edge_shard=sharded,
    )


def pad_node_embeddings(emb: np.ndarray, num_nodes_padded: int) -> np.ndarray:
    """Zero-pad the frozen ``[N, D]`` embedding matrix to the padded count."""
    n, d = emb.shape
    if num_nodes_padded < n:
        raise ValueError("padded node count smaller than real node count")
    out = np.zeros((num_nodes_padded, d), dtype=emb.dtype)
    out[:n] = emb
    return out
