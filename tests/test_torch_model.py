"""The port's model against the JAX model on the same weights.

Weights come from the JAX ``init_model`` through ``params_from_jax``; the
node embeddings and the graph are the same numpy arrays. Tolerance 1e-4
(rtol and atol), the repo's activation parity contract. The JAX XLA path
gives the last padded row a nonzero value (padded edges carry rel_bias[0]
into it), the Pallas path and the port's kernels leave it at 0: real rows
are compared against the XLA path, all rows against the Pallas path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu.config import ModelConfig as JaxModelConfig
from relgat_projector_tpu.data.graph import build_graph as jax_build_graph
from relgat_projector_tpu.models import model as jax_model
from relgat_projector_tpu_torch.config import ModelConfig
from relgat_projector_tpu_torch.data.graph import build_graph, pad_node_embeddings
from relgat_projector_tpu_torch.interop import params_from_jax
from relgat_projector_tpu_torch.models import model as port_model
from relgat_projector_tpu_torch.utils.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)
N, E, R, D = 120, 700, 5, 24


def _cfg_dict(scorer, use_pallas):
    return dict(
        in_dim=D, num_rel=R, gat_out_dim=8, gat_heads=3, gat_num_layers=2,
        dropout=0.0, project_to_input_size=True, projection_layers=2,
        scorer_type=scorer, use_pallas=use_pallas,
    )


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.default_rng(7)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    dst[:20] = rng.integers(N - 10, N, 20)
    et = rng.integers(0, R, E)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    b = 16
    batch = (rng.integers(0, N, b), rng.integers(0, R, b), rng.integers(0, N, b))
    return src, dst, et, emb, batch


@functools.lru_cache(maxsize=None)
def _jax_out(scorer, use_pallas):
    src, dst, et, emb, (bs, br, bd) = _data()
    cfg = JaxModelConfig(**_cfg_dict(scorer, use_pallas))
    g = jax_build_graph(src, dst, et, N, blocked=use_pallas, block_nodes=16,
                        chunk_edges=64)
    x = jnp.asarray(pad_node_embeddings(emb, g.num_nodes))
    params = jax_model.init_model(jax.random.PRNGKey(0), cfg)
    rep = jax_model.single_gat_step(params, cfg, x, g)
    scores, transformed, dst_vec = jax_model.forward(
        params, cfg, x, g, jnp.asarray(bs), jnp.asarray(br), jnp.asarray(bd)
    )
    host = jax.device_get(params)
    return (host, np.asarray(rep), np.asarray(scores),
            np.asarray(transformed), np.asarray(dst_vec))


@pytest.mark.parametrize("scorer", ("distmult", "transe"))
@pytest.mark.parametrize(
    "port_pallas,ref_pallas", [(False, False), (True, True), (True, False)]
)
def test_model_matches_jax(scorer, port_pallas, ref_pallas):
    src, dst, et, emb, (bs, br, bd) = _data()
    host, want_rep, want_scores, want_tr, want_dst = _jax_out(scorer, ref_pallas)
    cfg = ModelConfig(**_cfg_dict(scorer, port_pallas))
    g = build_graph(src, dst, et, N, num_rel=R, csr=port_pallas, device="cpu")
    x = torch.from_numpy(pad_node_embeddings(emb, g.num_nodes))
    params = params_from_jax(host, device="cpu")
    rep = port_model.single_gat_step(params, cfg, x, g).numpy()
    rows = slice(0, N) if port_pallas != ref_pallas else slice(None)
    np.testing.assert_allclose(rep[rows], want_rep[rows], **TOL)
    scores, tr, dvec = port_model.forward(
        params, cfg, x, g, *(torch.from_numpy(a) for a in (bs, br, bd))
    )
    np.testing.assert_allclose(scores.numpy(), want_scores, **TOL)
    np.testing.assert_allclose(tr.numpy(), want_tr, **TOL)
    np.testing.assert_allclose(dvec.numpy(), want_dst, **TOL)


def test_get_node_repr_and_transform_match_jax():
    src, dst, et, emb, (bs, br, _) = _data()
    host, want_rep, *_ = _jax_out("distmult", True)
    cfg = ModelConfig(**_cfg_dict("distmult", True))
    g = build_graph(src, dst, et, N, num_rel=R, csr=True, device="cpu")
    x = torch.from_numpy(pad_node_embeddings(emb, g.num_nodes))
    params = params_from_jax(host, device="cpu")
    rep = port_model.get_node_repr(params, cfg, x, g)
    assert rep.shape == (N, D) and not rep.requires_grad
    np.testing.assert_allclose(rep.numpy(), want_rep[:N], **TOL)
    jcfg = JaxModelConfig(**_cfg_dict("distmult", True))
    jparams = jax.tree_util.tree_map(jnp.asarray, host)
    want = jax_model.transform_from_vectors(
        jparams, jcfg, jnp.asarray(want_rep[bs]), jnp.asarray(br[:1])
    )
    got = port_model.transform_from_vectors(
        params, cfg, torch.from_numpy(want_rep[bs]), torch.from_numpy(br[:1])
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_keep_the_jax_layout():
    host = _jax_out("distmult", False)[0]
    params = params_from_jax(host, device="cpu")
    cfg = ModelConfig(**_cfg_dict("distmult", False))
    fresh = port_model.init_model(cfg, seed=0, device="cpu")
    flat_j = jax.tree_util.tree_leaves(host)
    for tree in (params, fresh):
        leaves = tree_leaves(tree)
        assert [tuple(t.shape) for t in leaves] == [a.shape for a in flat_j]
        assert all(t.dtype == torch.float32 for t in leaves)
