"""The port's partitioner (``relgat_projector_tpu_torch/data/partition.py``)
against the JAX package's.

- Where JAX's ``partition_node_permutation`` takes its NumPy route (its C++
  library switched off with ``RELGAT_NO_NATIVE``), the port's permutation,
  its statistics, and the LPA and BFS-growing passes equal JAX's exactly:
  on a clustered graph with shuffled ids (the two-level route runs), on a
  pre-clustered one, and on a graph too small for the two-level route.
- The port holds the caps and the cut as ``tests/test_partition.py`` does:
  exact per-range occupancy, a recovered cut near the natural one, and a
  halo pair that drops after partitioning.
- Relabeling preserves semantics: ``single_gat_step`` on the relabeled
  graph equals the original under the permutation, and the dataset's
  relabeled rows built one range at a time equal its whole matrix.
"""

import numpy as np
import pytest
import torch

from relgat_projector_tpu.data import partition as jax_partition
from relgat_projector_tpu_torch.config import ModelConfig
from relgat_projector_tpu_torch.data import partition
from relgat_projector_tpu_torch.data.dataset import RelGATData
from relgat_projector_tpu_torch.data.graph import (
    build_graph,
    pad_node_embeddings,
)
from relgat_projector_tpu_torch.data.synthetic import generate_synthetic_kg
from relgat_projector_tpu_torch.models.model import init_model, single_gat_step
from relgat_projector_tpu_torch.parallel.halo import (
    build_halo_graph,
    halo_rows_per_shard,
)


def _clustered(n, e, g, cross, seed=0):
    """g contiguous clusters, ``cross`` fraction of cross-cluster edges."""
    rng = np.random.default_rng(seed)
    rows = n // g
    srcs, dsts = [], []
    for d in range(g):
        lo = d * rows
        e_per = e // g
        e_cross = int(e_per * cross)
        dsts.append(rng.integers(lo, lo + rows, e_per))
        srcs.append(np.concatenate([
            rng.integers(lo, lo + rows, e_per - e_cross),
            rng.integers(0, n, e_cross),
        ]))
    return np.concatenate(srcs), np.concatenate(dsts)


def _case(name):
    if name == "shuffled":
        n, g = 2000, 4
        src, dst = _clustered(n, 16000, g, 0.05)
        shuf = np.random.default_rng(1).permutation(n)
        return shuf[src], shuf[dst], n, g
    if name == "preclustered":
        n, g = 2000, 4
        return (*_clustered(n, 16000, g, 0.05, seed=2), n, g)
    n, g = 300, 4  # below the two-level route's size
    rng = np.random.default_rng(3)
    return rng.integers(0, n, 2400), rng.integers(0, n, 2400), n, g


@pytest.mark.parametrize("name", ["shuffled", "preclustered", "small"])
def test_permutation_equals_jax_numpy_route(monkeypatch, name):
    monkeypatch.setenv("RELGAT_NO_NATIVE", "1")
    src, dst, n, g = _case(name)
    rows = halo_rows_per_shard(n, g)
    want, want_stats = jax_partition.partition_node_permutation(
        src, dst, n, g, rows)
    got, stats = partition.partition_node_permutation(src, dst, n, g, rows)
    assert np.array_equal(got, want)
    assert stats == want_stats
    caps = np.bincount(np.minimum(np.arange(n) // rows, g - 1), minlength=g)
    for fn in ("bfs_grow_partition", "lpa_partition"):
        assert np.array_equal(getattr(partition, fn)(src, dst, n, caps),
                              getattr(jax_partition, fn)(src, dst, n, caps))


def test_partitioner_recovers_shuffled_clusters():
    n, g = 4000, 8
    src, dst = _clustered(n, 32000, g, cross=0.05)
    shuf = np.random.default_rng(1).permutation(n)
    rows = halo_rows_per_shard(n, g)
    perm, stats = partition.partition_node_permutation(
        shuf[src], shuf[dst], n, g, rows)
    assert np.array_equal(np.sort(perm), np.arange(n))
    natural = partition.edge_cut_fraction(
        np.minimum(np.arange(n) // rows, g - 1), src, dst)
    assert stats["edge_cut_before"] > 0.8
    assert stats["edge_cut_after"] <= max(1.5 * natural, natural + 0.02)


def test_caps_are_exact_and_the_halo_pair_drops():
    n, g = 1000, 4
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, n, 6000), rng.integers(0, n, 6000)
    caps = np.array([256, 256, 256, 232], np.int64)
    for fn in (partition.lpa_partition, partition.bfs_grow_partition):
        assert np.array_equal(np.bincount(fn(src, dst, n, caps),
                                          minlength=g), caps)
    src, dst = _clustered(4000, 32000, g, cross=0.05)
    et = np.zeros_like(src)
    shuf = np.random.default_rng(1).permutation(4000)
    natural = build_halo_graph(src, dst, et, 4000, g).halo_pair
    shuffled = build_halo_graph(shuf[src], shuf[dst], et, 4000, g).halo_pair
    perm, _ = partition.partition_node_permutation(
        shuf[src], shuf[dst], 4000, g, halo_rows_per_shard(4000, g))
    parted = build_halo_graph(perm[shuf[src]], perm[shuf[dst]], et, 4000,
                              g).halo_pair
    assert shuffled > 3 * natural and parted <= 1.5 * natural


def test_relabeling_is_semantics_preserving():
    rng = np.random.default_rng(3)
    n, e, r, d = 200, 1200, 4, 16
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    et = rng.integers(0, r, e)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    cfg = ModelConfig(in_dim=d, num_rel=r, gat_out_dim=8, gat_heads=2,
                      gat_num_layers=2, dropout=0.0,
                      project_to_input_size=False)
    params = init_model(cfg, seed=0, device="cpu")
    perm, _ = partition.partition_node_permutation(
        src, dst, n, 4, halo_rows_per_shard(n, 4))
    g0 = build_graph(src, dst, et, n, device="cpu")
    x0 = single_gat_step(params, cfg, torch.from_numpy(
        pad_node_embeddings(emb, g0.num_nodes)), g0)
    g1 = build_graph(perm[src], perm[dst], et, n, device="cpu")
    x1 = single_gat_step(params, cfg, torch.from_numpy(
        pad_node_embeddings(emb[np.argsort(perm)], g1.num_nodes)), g1)
    np.testing.assert_allclose(x1.numpy()[perm], x0.numpy()[:n],
                               rtol=1e-5, atol=1e-6)


def test_dataset_builds_relabeled_rows_one_range_at_a_time():
    kg = generate_synthetic_kg(num_nodes=200, num_edges=1500, num_rel=4,
                               emb_dim=8, seed=1)
    kw = dict(device="cpu", halo_shards=4, halo_overlap=True,
              partition_nodes=True)
    whole = RelGATData(*kg, **kw)
    lazy = RelGATData(*kg, materialize_features=False, **kw)
    assert lazy.node_emb is None and whole.partition_stats is not None
    assert np.array_equal(lazy.node_perm, whole.node_perm)
    rows = lazy.graph.halo.rows_per_shard
    parts = [lazy.feature_rows(k * rows, (k + 1) * rows) for k in range(4)]
    assert np.array_equal(np.concatenate(parts), whole.node_emb)
    assert lazy.features_materialized_rows == 4 * rows
    for a, b in zip(lazy.train_batches(64), whole.train_batches(64)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
