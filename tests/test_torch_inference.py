"""The port's inference helpers against the JAX package's ``inference.py``.

The same weights (JAX ``init_model`` -> ``params_from_jax``) and the same
graph and embeddings; the port's forward on its plain path and on the kernel
route (the kernels' plain versions on the CPU), JAX's on its XLA path. Every
helper agrees within 1e-4 relative (the parity contract), and
``query_expansion`` returns the same ids, on continuous random data whose
top scores are not tied.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu import inference as jax_inference
from relgat_projector_tpu.config import ModelConfig as JaxModelConfig
from relgat_projector_tpu.data.graph import build_graph as jax_build_graph
from relgat_projector_tpu.models.model import init_model as jax_init_model
from relgat_projector_tpu_torch import inference
from relgat_projector_tpu_torch.config import ModelConfig
from relgat_projector_tpu_torch.data.graph import build_graph, pad_node_embeddings
from relgat_projector_tpu_torch.interop import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
N, E, R, D = 90, 500, 5, 16
SCORERS = ("distmult", "transe")
ROUTES = {"plain": False, "kernels": True}


def _model(scorer):
    return dict(in_dim=D, num_rel=R, gat_out_dim=8, gat_heads=2,
                gat_num_layers=2, dropout=0.0, project_to_input_size=True,
                projection_layers=2, scorer_type=scorer)


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.default_rng(11)
    return (rng.integers(0, N, E), rng.integers(0, N, E),
            rng.integers(0, R, E),
            rng.standard_normal((N, D)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_side(scorer):
    src, dst, et, emb = _data()
    cfg = JaxModelConfig(**_model(scorer))
    g = jax_build_graph(src, dst, et, N)
    x = jnp.asarray(pad_node_embeddings(emb, g.num_nodes))
    params = jax_init_model(jax.random.PRNGKey(2), cfg)
    rep = jax_inference.export_node_representations(params, cfg, x, g)
    return params, cfg, np.array(rep)  # a writable copy


def _port_side(scorer, route):
    src, dst, et, emb = _data()
    jparams, _, _ = _jax_side(scorer)
    cfg = ModelConfig(**_model(scorer), use_pallas=ROUTES[route])
    g = build_graph(src, dst, et, N, num_rel=R, csr=ROUTES[route],
                    device="cpu")
    x = torch.from_numpy(pad_node_embeddings(emb, g.num_nodes))
    params = params_from_jax(jax.device_get(jparams), "cpu")
    return params, cfg, x, g


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("scorer", SCORERS)
def test_export_node_representations(tmp_path, scorer, route):
    _, _, want = _jax_side(scorer)
    params, cfg, x, g = _port_side(scorer, route)
    path = tmp_path / "repr.npy"
    got = inference.export_node_representations(params, cfg, x, g, str(path))
    assert tuple(got.shape) == (N, D) and got.device == x.device
    np.testing.assert_array_equal(np.load(path), got.numpy())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("scorer", SCORERS)
def test_compose_relation_path(scorer):
    jparams, jcfg, rep = _jax_side(scorer)
    params, cfg, _, _ = _port_side(scorer, "plain")
    vecs = rep[:6]
    path = [2, 0, 4, 1]
    want = jax_inference.compose_relation_path(jparams, jcfg,
                                               jnp.asarray(vecs), path)
    got = inference.compose_relation_path(params, cfg,
                                          torch.from_numpy(vecs), path)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("scorer", SCORERS)
def test_query_expansion(scorer, route):
    jparams, jcfg, want_rep = _jax_side(scorer)
    params, cfg, x, g = _port_side(scorer, route)
    rep = inference.export_node_representations(params, cfg, x, g)
    queries = [3, 17, 40, 88]
    for rel in range(R):
        want_ids, want_scores = jax_inference.query_expansion(
            jparams, jcfg, jnp.asarray(want_rep), jnp.asarray(want_rep[queries]),
            rel_id=rel, top_k=10)
        want_scores = np.asarray(want_scores)
        # Continuous random data: the ranking has no near-ties to break.
        assert np.diff(want_scores, axis=1).max() < -1e-4
        ids, scores = inference.query_expansion(
            params, cfg, rep, rep[queries], rel_id=rel, top_k=10)
        assert tuple(ids.shape) == tuple(scores.shape) == (len(queries), 10)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(scores.numpy(), want_scores, **TOL)
    # One query vector is a batch of one.
    ids, _ = inference.query_expansion(params, cfg, rep, rep[5], rel_id=1,
                                       top_k=3)
    assert tuple(ids.shape) == (1, 3)


@pytest.mark.parametrize("scorer", SCORERS)
def test_impute_embedding(scorer):
    jparams, jcfg, rep = _jax_side(scorer)
    params, cfg, _, _ = _port_side(scorer, "plain")
    neighbors = [(3, 1), (10, 0), (20, 4), (3, 2)]
    want = jax_inference.impute_embedding(jparams, jcfg, jnp.asarray(rep),
                                          neighbors)
    got = inference.impute_embedding(params, cfg, torch.from_numpy(rep),
                                     neighbors)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="at least one neighbor"):
        inference.impute_embedding(params, cfg, torch.from_numpy(rep), [])


@pytest.mark.parametrize("scorer", SCORERS)
def test_score_candidates(scorer):
    jparams, jcfg, rep = _jax_side(scorer)
    params, cfg, _, _ = _port_side(scorer, "plain")
    cand = np.array([1, 5, 9, 60, 89])
    want = jax_inference.score_candidates(
        jparams, jcfg, jnp.asarray(rep), 2, 3, jnp.asarray(cand, jnp.int32))
    got = inference.score_candidates(params, cfg, torch.from_numpy(rep), 2,
                                     3, torch.from_numpy(cand))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
