"""Dataset orchestration: compaction, split, graph build, static batching.

Port of ``relgat_projector_tpu/data/dataset.py``, giving the same splits,
graph and batches for the same inputs:

- id compaction over sorted node ids (reference ``relgat_dataset.py:61-63``);
- a seeded shuffle from ``default_rng(seed)`` and a ratio split (``:70-88``);
- the message-passing graph built from TRAIN edges only, so eval edges
  never reach the propagation (``:123-137``), with the kernels' CSR layout
  when ``csr`` is set (the JAX package's ``blocked``);
- static-shape batches with a validity mask, int32 ids on the host, and an
  epoch order drawn from ``default_rng(seed + 1)``.

The CSR layout needs no tuning, so the JAX package's layout tuner and its
``block_nodes``/``chunk_edges`` have no counterpart here. ``scan_segments``
is accepted and changes nothing: the JAX package builds segment stacks for
its scanned propagate, which bounds the E-sized gather streams a TPU keeps
live, and the kernels here gather rows inside the kernel and keep no
E-sized float tensor, so the one CSR layout serves.

``halo_shards > 1`` builds the halo route's plan (``parallel/halo.py``),
with its local/remote split when ``halo_overlap``; ``partition_nodes``
then relabels the nodes first (``data/partition.py``), as the JAX package
does, and only then (without halo shards it does nothing). With
``materialize_features=False`` the ``[N, D]`` embedding matrix is never
stacked: a rank builds its own rows through ``feature_rows``.
``graph_shards > 1`` with ``csr`` builds the ``replicated`` route's
destination ranges in place of the layout (``parallel/pallas_sharded.py``);
as in the JAX package, the halo plan takes precedence and without ``csr``
it changes nothing.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from relgat_projector_tpu_torch.data.graph import (
    GraphData,
    build_graph,
    pad_node_embeddings,
)
from relgat_projector_tpu_torch.device import DeviceLike


class Batch(NamedTuple):
    src: np.ndarray     # [B] int32
    rel: np.ndarray     # [B] int32
    dst: np.ndarray     # [B] int32
    weight: np.ndarray  # [B] float32 validity mask (1 = real example)


class RelGATData:
    """Host-side dataset container feeding the device-resident train loop."""

    def __init__(
        self,
        node2emb: Dict[int, np.ndarray],
        rel2idx: Dict[str, int],
        edge_index_raw: List[Tuple[int, int, str]],
        *,
        train_ratio: float = 0.9,
        seed: int = 42,
        edge_pad_multiple: int = 128,
        node_pad_multiple: int = 8,
        csr: bool = False,
        graph_shards: int = 1,
        halo_shards: int = 0,
        halo_overlap: bool = False,
        scan_segments: int = 0,
        partition_nodes: bool = False,
        materialize_features: bool = True,
        device: DeviceLike = "cuda",
    ):
        self.rel2idx = dict(rel2idx)
        self.num_rel = len(rel2idx)
        self.train_ratio = float(train_ratio)
        self.seed = int(seed)

        # Sorted-id compaction (parity ``relgat_dataset.py:61-63``).
        self.all_node_ids = sorted(node2emb.keys())
        self.id2idx = {nid: i for i, nid in enumerate(self.all_node_ids)}
        self.num_nodes = len(self.all_node_ids)
        self.emb_dim = int(
            np.asarray(node2emb[self.all_node_ids[0]]).shape[-1]
        )
        # Without materialize_features the [N, D] matrix is never stacked:
        # each rank builds its rows through feature_rows.
        self._materialize = bool(materialize_features)
        self._node2emb = None if self._materialize else node2emb
        self.features_materialized_rows = 0
        emb = None
        if self._materialize:
            emb = np.stack(
                [
                    np.asarray(node2emb[nid], dtype=np.float32)
                    for nid in self.all_node_ids
                ]
            )

        # Map triplets onto compact indices and integer relation ids.
        def _rel_id(r):
            return self.rel2idx[r] if isinstance(r, str) else int(r)

        edges = np.asarray(
            [
                (self.id2idx[s], self.id2idx[d], _rel_id(r))
                for s, d, r in edge_index_raw
            ],
            dtype=np.int64,
        ).reshape(-1, 3)

        # Seeded shuffle + ratio split (parity ``relgat_dataset.py:70-88``).
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(edges.shape[0])
        edges = edges[perm]
        n_train = int(self.train_ratio * edges.shape[0])
        self.train_edges = edges[:n_train]
        self.eval_edges = edges[n_train:]
        print(f"Number of edges (relations): {edges.shape[0]}")
        print(
            f" - train: {len(self.train_edges)} ({self.train_ratio * 100:.1f} %)"
        )
        print(
            f" - eval: {len(self.eval_edges)} "
            f"({100 - self.train_ratio * 100:.1f} %)"
        )

        # Min-cut relabeling for the halo route: clusters of train-edge
        # structure packed into the shards' contiguous id ranges, applied
        # to the embeddings and both edge splits alike. On a grid every
        # rank gets here (the condition is the run config's), because the
        # partitioner broadcasts rank 0's permutation over the world.
        self.node_perm: Optional[np.ndarray] = None
        self.partition_stats: Optional[Dict[str, float]] = None
        if partition_nodes and halo_shards > 1:
            from relgat_projector_tpu_torch.data.partition import (
                partition_node_permutation,
            )
            from relgat_projector_tpu_torch.parallel.halo import (
                halo_rows_per_shard,
            )

            rows = halo_rows_per_shard(self.num_nodes, halo_shards)
            perm, stats = partition_node_permutation(
                self.train_edges[:, 0], self.train_edges[:, 1],
                self.num_nodes, halo_shards, rows,
            )
            self.node_perm = perm
            self.partition_stats = stats
            if emb is not None:
                emb = emb[np.argsort(perm)]  # row new_id = old node's emb
            for arr in (self.train_edges, self.eval_edges):
                arr[:, 0] = perm[arr[:, 0]]
                arr[:, 1] = perm[arr[:, 1]]
            print(
                "Partitioned nodes for halo exchange: edge cut "
                f"{stats['edge_cut_before']:.3f} -> "
                f"{stats['edge_cut_after']:.3f} over {halo_shards} shards"
            )

        # Message-passing graph from TRAIN edges only (``:123-137``).
        self.graph: GraphData = build_graph(
            self.train_edges[:, 0],
            self.train_edges[:, 1],
            self.train_edges[:, 2],
            num_nodes=self.num_nodes,
            num_rel=self.num_rel,
            csr=csr,
            edge_pad_multiple=edge_pad_multiple,
            node_pad_multiple=node_pad_multiple,
            graph_shards=graph_shards,
            halo_shards=halo_shards,
            halo_overlap=halo_overlap,
            device=device,
        )
        # Frozen embeddings, zero-padded to the graph's node count (host;
        # None without materialize_features).
        self.node_emb = (pad_node_embeddings(emb, self.graph.num_nodes)
                         if emb is not None else None)

        self._epoch_rng = np.random.default_rng(self.seed + 1)

    def feature_rows(self, lo: int, hi: int) -> np.ndarray:
        """Rows ``[lo, hi)`` of the (relabeled, padded) embedding matrix:
        a rank's own rows (JAX ``feature_rows``). Rows past the real nodes
        are zeros; with a partition, row ``new_id`` holds the embedding of
        the node relabeled to it. ``features_materialized_rows`` counts the
        rows built, so a test can see that a rank never built them all."""
        lo, hi = int(lo), int(hi)
        out = np.zeros((hi - lo, self.emb_dim), np.float32)
        n_real = min(hi, self.num_nodes) - lo
        if n_real > 0:
            if self._materialize:
                out[:n_real] = self.node_emb[lo:lo + n_real]
            else:
                new_ids = np.arange(lo, lo + n_real)
                old_ids = (np.argsort(self.node_perm)[new_ids]
                           if self.node_perm is not None else new_ids)
                for i, o in enumerate(old_ids):
                    out[i] = np.asarray(
                        self._node2emb[self.all_node_ids[int(o)]], np.float32
                    )
        self.features_materialized_rows += hi - lo
        return out

    @property
    def num_train(self) -> int:
        return int(self.train_edges.shape[0])

    @property
    def num_eval(self) -> int:
        return int(self.eval_edges.shape[0])

    def _iter_batches(
        self,
        edges: np.ndarray,
        batch_size: int,
        shuffle: bool,
        drop_last: bool = False,
        rng: Optional[np.random.Generator] = None,
    ) -> Iterator[Batch]:
        n = edges.shape[0]
        order = (
            (rng or self._epoch_rng).permutation(n) if shuffle else np.arange(n)
        )
        end = (n // batch_size) * batch_size if drop_last else n
        for lo in range(0, end, batch_size):
            idx = order[lo : lo + batch_size]
            b = idx.shape[0]
            src = np.zeros(batch_size, np.int32)
            rel = np.zeros(batch_size, np.int32)
            dst = np.zeros(batch_size, np.int32)
            w = np.zeros(batch_size, np.float32)
            chunk = edges[idx]
            src[:b] = chunk[:, 0]
            dst[:b] = chunk[:, 1]
            rel[:b] = chunk[:, 2]
            w[:b] = 1.0
            yield Batch(src=src, rel=rel, dst=dst, weight=w)

    def train_batches(self, batch_size: int) -> Iterator[Batch]:
        """Static-shape shuffled epoch over train triplets."""
        return self._iter_batches(self.train_edges, batch_size, shuffle=True)

    def eval_batches(self, batch_size: int) -> Iterator[Batch]:
        return self._iter_batches(self.eval_edges, batch_size, shuffle=False)

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, -(-self.num_train // batch_size))
