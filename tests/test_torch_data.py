"""The port's data pipeline against the JAX package's, array for array.

- ``generate_synthetic_kg``: bit-equal output for the pooled branch, the
  exact-NN branch (``nn_pool >= num_nodes``) and ``self_loops``.
- ``load_embeddings_and_edges``: equal on the same files, including the
  filtering of triplets whose endpoints have no embedding.
- ``RelGATData``: against JAX ``RelGATData(blocked=False)`` on the same
  inputs, equal train/eval splits, padded embeddings, graph COO, the first
  two epochs of train batches and all eval batches.
"""

import json
import pickle

import numpy as np
import pytest

from relgat_projector_tpu.data.dataset import RelGATData as JaxRelGATData
from relgat_projector_tpu.data.io import (
    load_embeddings_and_edges as jax_load,
)
from relgat_projector_tpu.data.synthetic import (
    generate_synthetic_kg as jax_generate,
)
from relgat_projector_tpu_torch.data import (
    RelGATData,
    generate_synthetic_kg,
    load_embeddings_and_edges,
)

SYNTHETIC_CASES = {
    "pooled": dict(num_nodes=400, num_edges=3000, num_rel=5, emb_dim=24,
                   seed=3, nn_pool=64),
    "exact_nn": dict(num_nodes=150, num_edges=1000, num_rel=3, emb_dim=16,
                     seed=5, nn_pool=1_000),
    "self_loops": dict(num_nodes=200, num_edges=1500, num_rel=4, emb_dim=8,
                       seed=1, self_loops=True),
}


def _assert_kg_equal(got, want):
    g_emb, g_rel, g_trip = got
    w_emb, w_rel, w_trip = want
    assert g_rel == w_rel
    assert g_trip == w_trip
    assert sorted(g_emb) == sorted(w_emb)
    for k in w_emb:
        assert g_emb[k].dtype == w_emb[k].dtype
        assert np.array_equal(g_emb[k], w_emb[k])


@pytest.mark.parametrize("case", sorted(SYNTHETIC_CASES))
def test_synthetic_kg_is_bit_equal(case):
    kw = SYNTHETIC_CASES[case]
    _assert_kg_equal(generate_synthetic_kg(**kw), jax_generate(**kw))


def test_load_embeddings_and_edges_matches(tmp_path):
    rng = np.random.default_rng(0)
    node2emb = {int(i): rng.standard_normal(6).astype(np.float64)
                for i in (3, 7, 11, 40, 41)}
    rels = {"hypernym": 0, "meronym": 1}
    triplets = [[3, 7, "hypernym"], [7, 11, "meronym"], [3, 99, "hypernym"],
                [98, 40, "meronym"], ["41", "40", "hypernym"]]
    paths = [tmp_path / "nodes.pkl", tmp_path / "rels.json",
             tmp_path / "triplets.json"]
    with open(paths[0], "wb") as f:
        pickle.dump(node2emb, f)
    paths[1].write_text(json.dumps(rels))
    paths[2].write_text(json.dumps(triplets))
    args = [str(p) for p in paths]
    got, want = load_embeddings_and_edges(*args), jax_load(*args)
    _assert_kg_equal(got, want)
    assert len(got[2]) == 3  # the two triplets with an unknown end are gone


def _data_pair(use_csr, **kw):
    node2emb, rel2idx, triplets = generate_synthetic_kg(
        num_nodes=300, num_edges=2500, num_rel=4, emb_dim=16, seed=2,
        self_loops=True)
    # Ids that are not 0..N-1, so the sorted-id compaction matters.
    node2emb = {3 * k + 10: v for k, v in node2emb.items()}
    triplets = [(3 * s + 10, 3 * d + 10, r) for s, d, r in triplets]
    port = RelGATData(node2emb, rel2idx, triplets, csr=use_csr,
                      device="cpu", **kw)
    ref = JaxRelGATData(node2emb, rel2idx, triplets, blocked=False, **kw)
    return port, ref


@pytest.mark.parametrize("use_csr", (False, True))
def test_relgat_data_matches(use_csr):
    port, ref = _data_pair(use_csr, train_ratio=0.85, seed=11)
    assert np.array_equal(port.train_edges, ref.train_edges)
    assert np.array_equal(port.eval_edges, ref.eval_edges)
    assert port.node_emb.dtype == ref.node_emb.dtype
    assert np.array_equal(port.node_emb, ref.node_emb)
    assert (port.num_nodes, port.num_rel, port.emb_dim) == (
        ref.num_nodes, ref.num_rel, ref.emb_dim)
    g, rg = port.graph, ref.graph
    assert g.num_nodes == rg.num_nodes
    assert g.num_real_nodes == rg.num_real_nodes
    assert g.num_real_edges == rg.num_real_edges
    for name in ("src", "dst", "etype"):
        assert np.array_equal(getattr(g, name).numpy(),
                              np.asarray(getattr(rg, name))), name
    assert (g.csr is not None) == use_csr
    for _ in range(2):  # two epochs: the epoch stream advances alike
        for a, b in zip(port.train_batches(128), ref.train_batches(128),
                        strict=True):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    for a, b in zip(port.eval_batches(100), ref.eval_batches(100),
                    strict=True):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert port.steps_per_epoch(128) == ref.steps_per_epoch(128)


@pytest.mark.parametrize("kw", [dict(graph_shards=2),
                                dict(graph_shards=2, halo_shards=2),
                                dict(graph_shards=4, scan_segments=4)])
def test_relgat_data_rejects_what_is_not_ported(kw):
    """Graph shards (the replicated route) are ported: without the kernels'
    layout they change nothing and the halo plan takes precedence, as in
    the JAX package; with it, the ranges hold every real edge once, in
    dst order."""
    kg = generate_synthetic_kg(num_nodes=20, num_edges=50, num_rel=2,
                               emb_dim=4, seed=0)
    port = RelGATData(*kg, device="cpu", **kw)
    ref = JaxRelGATData(*kg, **kw)
    for name in ("src", "dst", "etype"):
        assert np.array_equal(getattr(port.graph, name).numpy(),
                              np.asarray(getattr(ref.graph, name)))
    assert port.graph.num_nodes == ref.graph.num_nodes
    assert port.graph.edge_shard is None
    assert (port.graph.halo is not None) == ("halo_shards" in kw)
    if "halo_shards" in kw:
        return
    plan = RelGATData(*kg, device="cpu", csr=True, **kw).graph.edge_shard
    assert plan.num_shards == kw["graph_shards"]
    assert plan.edge_ptr[0] == 0 and plan.edge_ptr[-1] == plan.src.shape[0]
    rows = plan.rows_per_shard
    for g in range(plan.num_shards):
        lo, hi = plan.edge_ptr[g], plan.edge_ptr[g + 1]
        assert np.all(plan.dst[lo:hi] // rows == g)


def test_partition_nodes_alone_changes_nothing():
    kg = generate_synthetic_kg(num_nodes=300, num_edges=2500, num_rel=4,
                               emb_dim=16, seed=2)
    part = RelGATData(*kg, seed=4, partition_nodes=True, device="cpu")
    plain = RelGATData(*kg, seed=4, device="cpu")
    assert np.array_equal(part.train_edges, plain.train_edges)
    assert np.array_equal(part.node_emb, plain.node_emb)
