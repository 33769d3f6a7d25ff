"""Graph partitioner: node relabeling that minimizes halo-exchange traffic.

Port of ``relgat_projector_tpu/data/partition.py``, its NumPy route. The
halo route (``parallel/halo.py``) partitions destination rows by contiguous
node-id ranges, so its boundary traffic (``halo_pair``) depends on how node
ids are laid out: a clustered KG whose labels arrive shuffled pays
near-worst-case exchange. This module groups strongly connected nodes by
capacity-constrained label propagation, seeded by BFS growing, and packs
each group into one shard's id range. The result is a relabeling
permutation, applied by ``data/dataset.py`` to embeddings and both edge
splits; model semantics are permutation-invariant.

The JAX package runs the LPA and BFS passes in C++ when its native library
loads (``data/native.py``) and broadcasts process 0's permutation, because
the two routes give different partitions. The port has the NumPy route
only, which is deterministic, so every rank computes the same permutation.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def edge_cut_fraction(
    labels: np.ndarray, src: np.ndarray, dst: np.ndarray
) -> float:
    """Fraction of edges whose endpoints live in different parts."""
    if src.shape[0] == 0:
        return 0.0
    return float(np.mean(labels[src] != labels[dst]))


def _neighbor_label_counts(
    u: np.ndarray, v: np.ndarray, labels: np.ndarray, n: int, g: int
) -> np.ndarray:
    """``counts[i, l]`` = number of ``i``'s neighbors currently labeled
    ``l`` (``u``/``v`` are the undirected incidence endpoints)."""
    return np.bincount(u * g + labels[v], minlength=n * g).reshape(n, g)


def lpa_partition(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    caps: np.ndarray,
    *,
    init_labels: Optional[np.ndarray] = None,
    max_passes: int = 40,
    slack: float = 0.15,
) -> np.ndarray:
    """Size-constrained label propagation.

    Starts from ``init_labels`` (default: the contiguous-range status quo,
    so the result can only improve on no-partitioning) and repeatedly moves
    each node to the label most common among its neighbors. During the
    passes the per-part size cap is relaxed to ``caps * (1 + slack)`` —
    with exactly-tight caps no node could ever move without a
    simultaneous swap — and a final repair phase evicts the
    lowest-attachment members of overfull parts into the remaining
    deficits, so the returned labeling satisfies ``caps`` EXACTLY
    (``bincount(labels) == caps``). Deterministic (no RNG).
    """
    n = int(num_nodes)
    g = int(caps.shape[0])
    caps = np.asarray(caps, np.int64)

    if init_labels is None:
        # Status-quo contiguous ranges of size cap (what dst // rows does).
        bounds = np.cumsum(caps)
        labels = np.searchsorted(bounds, np.arange(n), side="right")
        labels = np.minimum(labels, g - 1).astype(np.int64)
    else:
        labels = np.asarray(init_labels, np.int64).copy()

    if src.shape[0] == 0 or g <= 1:
        return labels

    # Undirected incidence: each edge contributes to both endpoints' votes.
    u = np.concatenate([src, dst]).astype(np.int64)
    v = np.concatenate([dst, src]).astype(np.int64)
    # Self-loops vote for the node's own current label — pure noise for the
    # cut objective; drop them.
    keep = u != v
    u, v = u[keep], v[keep]

    soft_caps = np.maximum(
        caps, np.ceil(caps * (1.0 + float(slack))).astype(np.int64)
    )
    idx = np.arange(n)
    best_cut = float(np.mean(labels[u] != labels[v]))
    best_labels = labels.copy()
    stale = 0
    for _ in range(max_passes):
        counts = _neighbor_label_counts(u, v, labels, n, g)
        best = np.argmax(counts, axis=1)
        gain = counts[idx, best] - counts[idx, labels]
        movers = np.flatnonzero((best != labels) & (gain > 0))
        if movers.size == 0:
            break
        # Track the best labeling seen: synchronous LPA can oscillate or
        # even regress for a pass (two neighbors moving toward each other's
        # old label), so the loop keeps a snapshot and exits after two
        # passes without meaningful improvement.
        cut = float(np.mean(labels[u] != labels[v]))
        if cut < best_cut - 1e-4:
            best_cut, best_labels, stale = cut, labels.copy(), 0
        else:
            stale += 1
            if stale >= 2:
                break

        # Detach movers from their parts, then admit into targets by
        # descending gain while soft capacity lasts; the rest revert.
        # (Reverts can push a part past its soft cap when newcomers
        # already filled it — that transient overshoot is what the repair
        # phase exists to clean up; the soft cap only has to keep parts
        # ROUGHLY balanced so repair stays cheap.)
        sizes = np.bincount(labels, minlength=g)
        sizes -= np.bincount(labels[movers], minlength=g)

        want = best[movers]
        order = np.lexsort((-gain[movers], want))  # by target, gain desc
        movers_sorted = movers[order]
        want_sorted = want[order]
        group_start = np.searchsorted(want_sorted, np.arange(g), "left")
        rank = np.arange(movers_sorted.size) - group_start[want_sorted]
        admit = rank < np.maximum(soft_caps - sizes, 0)[want_sorted]
        if not np.any(admit):
            break
        labels[movers_sorted[admit]] = want_sorted[admit]

    final_cut = float(np.mean(labels[u] != labels[v]))
    if best_cut < final_cut:
        labels = best_labels

    return _repair_to_caps(labels, caps, u, v, n, g)


def _repair_to_caps(
    labels: np.ndarray,
    caps: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    n: int,
    g: int,
) -> np.ndarray:
    """Evict the lowest-attachment members of overfull parts into parts
    with spare capacity until ``bincount(labels) == caps`` exactly. Each
    evictee goes to its most-connected under-capacity part when that part
    still has room; stragglers fill the remaining deficit arbitrarily."""
    labels = labels.copy()
    sizes = np.bincount(labels, minlength=g)
    surplus = sizes - caps
    if not np.any(surplus > 0):
        assert np.array_equal(sizes, caps)
        return labels

    counts = _neighbor_label_counts(u, v, labels, n, g)
    attach = counts[np.arange(n), labels]

    evictees = []
    for k in np.flatnonzero(surplus > 0):
        members = np.flatnonzero(labels == k)
        weakest = members[
            np.argsort(attach[members], kind="stable")[: surplus[k]]
        ]
        evictees.append(weakest)
    evictees = np.concatenate(evictees)

    deficit = np.maximum(caps - sizes, 0)
    # First choice: best-connected deficit part, admitted by connection
    # strength while the deficit lasts.
    c = counts[evictees].astype(np.int64)
    c[:, deficit == 0] = -1
    tgt = np.argmax(c, axis=1)
    strength = c[np.arange(evictees.size), tgt]
    order = np.lexsort((-strength, tgt))
    ev_sorted, tgt_sorted = evictees[order], tgt[order]
    group_start = np.searchsorted(tgt_sorted, np.arange(g), "left")
    rank = np.arange(ev_sorted.size) - group_start[tgt_sorted]
    admit = rank < deficit[tgt_sorted]
    labels[ev_sorted[admit]] = tgt_sorted[admit]

    # Stragglers: fill whatever deficit remains (total surplus == total
    # deficit, so the repeat below covers every leftover exactly).
    left = ev_sorted[~admit]
    if left.size:
        deficit = deficit - np.bincount(tgt_sorted[admit], minlength=g)
        fill = np.repeat(np.arange(g), deficit)
        labels[left] = fill[: left.size]

    assert np.array_equal(np.bincount(labels, minlength=g), caps)
    return labels


def bfs_grow_partition(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    caps: np.ndarray,
) -> np.ndarray:
    """Greedy graph-growing seeding (the GGGP idea from the classic
    multilevel partitioners, vectorized in wave form): grow each part from
    a max-degree unassigned seed by whole BFS waves until its capacity is
    reached. On a clustered graph a BFS wave almost never leaves the
    cluster, so this recovers cluster structure even when node labels
    arrive fully shuffled — the regime where synchronous label propagation
    started from a random-w.r.t.-structure init stalls."""
    n = int(num_nodes)
    g = int(caps.shape[0])
    caps = np.asarray(caps, np.int64)
    if src.shape[0] == 0 or g <= 1:
        return np.zeros(n, np.int64)

    # Undirected CSR adjacency.
    u = np.concatenate([src, dst]).astype(np.int64)
    v = np.concatenate([dst, src]).astype(np.int64)
    keep = u != v
    u, v = u[keep], v[keep]
    deg = np.bincount(u, minlength=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = v[np.argsort(u, kind="stable")]

    labels = np.full(n, -1, np.int64)
    # Seed order: degree descending (stable → deterministic).
    seed_order = np.argsort(-deg, kind="stable")
    seed_ptr = 0

    for k in range(g):
        room = int(caps[k])
        if room == 0:
            continue
        frontier = np.zeros(0, np.int64)
        while room > 0:
            if frontier.size == 0:
                # (Re)seed: next unassigned max-degree node — handles both
                # the start of a part and disconnected components.
                while (
                    seed_ptr < n and labels[seed_order[seed_ptr]] != -1
                ):
                    seed_ptr += 1
                if seed_ptr >= n:
                    break
                frontier = seed_order[seed_ptr : seed_ptr + 1]
            take = frontier[:room]
            labels[take] = k
            room -= take.size
            if room == 0:
                break
            # Next wave: unassigned neighbors of what we just took.
            lo, hi = indptr[take], indptr[take + 1]
            lengths = hi - lo
            total = int(lengths.sum())
            starts = np.cumsum(lengths) - lengths
            flat = (
                np.repeat(lo - starts, lengths) + np.arange(total)
                if total
                else np.zeros(0, np.int64)
            )
            nbr = np.unique(indices[flat])
            frontier = nbr[labels[nbr] == -1]

    # Any still-unassigned nodes (all parts hit capacity via waves that
    # skipped them) cannot exist — caps sum to n — but guard anyway by
    # filling remaining deficit.
    left = np.flatnonzero(labels == -1)
    if left.size:
        deficit = caps - np.bincount(labels[labels >= 0], minlength=g)
        fill = np.repeat(np.arange(g), np.maximum(deficit, 0))
        labels[left] = fill[: left.size]
    return labels


def _pack_micro_parts(
    W: np.ndarray,
    msizes: np.ndarray,
    caps: np.ndarray,
    slack: float = 0.05,
) -> np.ndarray:
    """Agglomerative packing of M micro-parts into ``len(caps)`` shards:
    repeatedly merge the pair of groups sharing the most cross-edges whose
    combined size still fits a (slack-relaxed) shard, until ``g`` groups
    remain. ``W[a, b]`` = cross-edge count between micro-parts a and b.
    Returns the micro-part -> shard assignment."""
    M = int(msizes.shape[0])
    g = int(caps.shape[0])
    W = W.astype(np.float64).copy()
    np.fill_diagonal(W, 0)
    gsz = np.asarray(msizes, np.int64).copy()
    soft = int(np.ceil(caps.max() * (1.0 + slack)))
    alive = np.ones(M, bool)
    parent = np.arange(M)
    while int(alive.sum()) > g:
        feas = np.add.outer(gsz, gsz) <= soft
        Wv = np.where(feas, W, -1.0)
        Wv[~alive] = -1.0
        Wv[:, ~alive] = -1.0
        np.fill_diagonal(Wv, -1.0)
        a, b = np.unravel_index(int(np.argmax(Wv)), Wv.shape)
        if Wv[a, b] < 0:
            # No affine feasible pair left: merge the two smallest groups
            # (overshoot gets cleaned up by the caller's repair phase).
            order = np.argsort(np.where(alive, gsz, np.iinfo(np.int64).max))
            a, b = int(order[0]), int(order[1])
        parent[parent == b] = a
        gsz[a] += gsz[b]
        alive[b] = False
        W[a] += W[b]
        W[:, a] += W[:, b]
        W[b] = 0.0
        W[:, b] = 0.0
    remap = np.full(M, -1, np.int64)
    remap[np.flatnonzero(alive)] = np.arange(g)
    return remap[parent]


def _two_level_labels(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    g: int,
    caps: np.ndarray,
    max_passes: int,
) -> Optional[np.ndarray]:
    """Oversegment-then-merge: BFS-grow + LPA at M ≈ 4g micro-parts (small
    parts track individual clusters even when a shard must hold several),
    pack micro-parts into shards by affinity, refine at shard level. This
    is the path that wins when the graph has more natural clusters than
    shards — direct g-way growing then merges clusters arbitrarily."""
    M = 4 * g
    if n < 64 * M:  # micro-parts would be too small to mean anything
        return None
    mcap = -(-n // M)
    mcaps = np.full(M, mcap, np.int64)
    mcaps[-1] -= int(mcaps.sum() - n)
    if mcaps[-1] <= 0:
        return None
    grown = bfs_grow_partition(src, dst, n, mcaps)
    micro = lpa_partition(
        src, dst, n, mcaps, init_labels=grown, max_passes=max_passes
    )
    # Quotient-graph weights between micro-parts (self column zeroed).
    W = np.bincount(
        micro[src] * M + micro[dst], minlength=M * M
    ).reshape(M, M)
    W = W + W.T
    np.fill_diagonal(W, 0)
    msizes = np.bincount(micro, minlength=M)
    assign = _pack_micro_parts(W, msizes, caps)
    return assign[micro]


def partition_node_permutation(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    num_shards: int,
    rows_per_shard: int,
    *,
    max_passes: int = 40,
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Compute a node relabeling ``perm`` (old id -> new id, a bijection on
    ``[0, num_nodes)``) that packs label-propagation clusters into the halo
    path's contiguous ranges ``[k*rows_per_shard, (k+1)*rows_per_shard)``.

    ``rows_per_shard`` must come from
    :func:`relgat_projector_tpu_torch.parallel.halo.halo_rows_per_shard` so the
    pack target matches ``build_halo_graph``'s ``dst // rows`` partition
    exactly.

    Returns ``(perm, stats)`` where stats holds the edge-cut fraction
    before/after (the direct proxy for ``halo_pair``).
    """
    n = int(num_nodes)
    g = int(num_shards)
    rows = int(rows_per_shard)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)

    # Real-node capacity of each contiguous range (trailing ranges can be
    # partially or fully padding when g*rows > n).
    caps = np.array(
        [max(0, min((k + 1) * rows, n) - k * rows) for k in range(g)],
        np.int64,
    )
    assert int(caps.sum()) == n

    status_quo = np.minimum(np.arange(n) // rows, g - 1)
    cut_before = edge_cut_fraction(status_quo, src, dst)

    # Three candidate inits — the status quo (pre-clustered id orders stay
    # put), direct g-way BFS growing, and the two-level oversegment+merge
    # (wins when the graph has more natural clusters than shards) — each
    # refined with size-constrained label propagation (which also repairs
    # sizes to the exact caps); the best FINAL cut wins. Refinement order
    # matters: LPA from a good agglomerative packing routinely escapes
    # local optima the direct seeding gets stuck in.
    candidates = [status_quo, bfs_grow_partition(src, dst, n, caps)]
    two_level = _two_level_labels(src, dst, n, g, caps, max_passes)
    if two_level is not None:
        candidates.append(two_level)
    labels, cut_after = None, np.inf
    for init in candidates:
        refined = lpa_partition(
            src, dst, n, caps, init_labels=init, max_passes=max_passes
        )
        cut = edge_cut_fraction(refined, src, dst)
        if cut < cut_after:
            labels, cut_after = refined, cut

    # Pack part k's members (stable order) into its id range.
    order = np.argsort(labels, kind="stable")  # nodes grouped by part
    part_sizes = np.bincount(labels, minlength=g)
    offsets = np.repeat(
        np.arange(g, dtype=np.int64) * rows, part_sizes
    ) + (
        np.arange(n, dtype=np.int64)
        - np.repeat(np.cumsum(part_sizes) - part_sizes, part_sizes)
    )
    perm = np.empty(n, np.int64)
    perm[order] = offsets
    # Capacity enforcement guarantees every new id is a real-node id.
    assert perm.max() < n and perm.min() >= 0

    stats = {
        "edge_cut_before": cut_before,
        "edge_cut_after": cut_after,
        "num_shards": float(g),
    }
    return perm, stats
