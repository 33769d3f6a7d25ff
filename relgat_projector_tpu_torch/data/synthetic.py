"""Synthetic knowledge-graph generator for tests and benchmarks.

This package's own copy of ``relgat_projector_tpu/data/synthetic.py``: the
same arguments give the same numpy stream and so bit-identical output
(``tests/test_torch_data.py`` holds the two together).

Covers BASELINE config #1 ("synthetic 10k-node / 100k-triplet KG, 8
relations, frozen random 200-d embeddings") and scaled variants. Generates a
*learnable* KG: relations act as random linear operators in embedding space
and each edge's destination is the (noisy) nearest neighbor of the
transformed source, so MRR above random is achievable with frozen random
node embeddings.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def generate_synthetic_kg(
    num_nodes: int = 10_000,
    num_edges: int = 100_000,
    num_rel: int = 8,
    emb_dim: int = 200,
    seed: int = 0,
    structured: bool = True,
    self_loops: bool = False,
    nn_pool: int = 0,
) -> Tuple[Dict[int, np.ndarray], Dict[str, int], List[Tuple[int, int, str]]]:
    """Returns ``(node2emb, rel2idx, triplets)`` in ingestion format.

    ``self_loops=True`` appends one ``(i, i, "rel_self")`` triplet per node
    (an extra relation). The RelGAT family aggregates ONLY in-neighbors —
    a node's own embedding never reaches its output (reference
    ``core/model/layer.py:304-309``), which makes the structured task's
    own-embedding signal invisible on held-out edges and pins eval MRR
    near random regardless of implementation (PARITY.md round-2 caveat).
    Self-loops reintroduce each node's features through an ordinary edge —
    a DATASET property, identical for both implementations — turning the
    structured KG into a task this model family demonstrably learns."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((num_nodes, emb_dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)

    rel_names = [f"rel_{i}" for i in range(num_rel)]
    rel2idx = {name: i for i, name in enumerate(rel_names)}

    src = rng.integers(0, num_nodes, size=num_edges)
    rel = rng.integers(0, num_rel, size=num_edges)

    if structured:
        # Per-relation DIAGONAL operator (elementwise scaling): dst = node
        # whose embedding is closest to r ⊙ src_emb within a small candidate
        # pool (O(E * pool), not O(E * N)). Diagonal operators are exactly
        # representable by the DistMult scorer, so the benchmark measures
        # convergence of a learnable task rather than an inexpressible one.
        ops = rng.choice(
            np.asarray([-1.0, 1.0], np.float32), size=(num_rel, emb_dim)
        ) * (0.5 + rng.random((num_rel, emb_dim)).astype(np.float32))
        # Pool scales with the graph: a fixed 256-candidate pool is half of
        # a 500-node graph (near-true nearest neighbor, strong structure)
        # but 2.6% of a 10k-node one — the dst mapping degenerated toward
        # noise exactly at BASELINE scale, which is why eval MRR pinned
        # near random there for BOTH implementations (PARITY.md).
        # ``nn_pool`` overrides (``>= num_nodes`` selects the exact-NN
        # branch, the cleanest structure the task can carry).
        pool_size = (
            min(int(nn_pool), num_nodes)
            if nn_pool
            else min(max(256, num_nodes // 4), num_nodes)
        )
        dst = np.empty(num_edges, dtype=np.int64)
        # Bound the per-chunk working set: the pooled branch materializes
        # ``emb[cand]`` of shape [chunk, pool_size, emb_dim], so keep
        # chunk * pool_size ~= 4096 * 256 (the original fixed-pool budget,
        # ~0.8 GB at dim 200) no matter how pool_size scales with the graph
        # — at 100k nodes the old fixed chunk was a ~26 GB OOM.
        chunk = (
            4096
            if pool_size >= num_nodes
            else max(64, (4096 * 256) // pool_size)
        )
        for lo in range(0, num_edges, chunk):
            hi = min(lo + chunk, num_edges)
            s, r = src[lo:hi], rel[lo:hi]
            target = ops[r] * emb[s]
            if pool_size >= num_nodes:
                # Exact nearest neighbor (one chunked matmul; the sampled
                # einsum would materialize [chunk, n, d]).
                dst[lo:hi] = np.argmax(target @ emb.T, axis=1)
            else:
                # ONE shared candidate pool per chunk: sims become a BLAS
                # [chunk, d] @ [d, pool] matmul. The per-ROW pool variant
                # (einsum over emb[cand] of [chunk, pool, d]) materialized
                # a multi-GB gather per chunk — non-BLAS fancy indexing
                # that ran ~1 h at dim 1152/120k nodes for the doc-scale
                # rehearsal. Equivalence to per-row pools is MARGINAL-
                # distribution-only (each dst is still an argmax over
                # `pool_size` uniform candidates): within a chunk the
                # rows share one pool, so generically-attractive
                # candidates win many rows at once (winner-take-many),
                # correlating dsts and inflating dst-degree variance/CV
                # versus independent pools — and same-seed datasets
                # differ from the pre-r4 generator (ADVICE r4 #2). Tests
                # and the layout tuner anchor on degree statistics
                # MEASURED from the generated graph, not on an assumed
                # CV, so the correlation is benign here; draw several
                # sub-pools per chunk (still BLAS) if tighter
                # equivalence ever matters.
                cand = rng.integers(0, num_nodes, size=pool_size)
                sims = target @ emb[cand].T
                dst[lo:hi] = cand[np.argmax(sims, axis=1)]
    else:
        dst = rng.integers(0, num_nodes, size=num_edges)

    node2emb = {i: emb[i] for i in range(num_nodes)}
    triplets = [
        (int(s), int(d), rel_names[int(r)]) for s, d, r in zip(src, dst, rel)
    ]
    if self_loops:
        rel2idx["rel_self"] = num_rel
        triplets += [(i, i, "rel_self") for i in range(num_nodes)]
    return node2emb, rel2idx, triplets
