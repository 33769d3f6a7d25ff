"""Heads wider than 128 features: the port's propagate and GAT layer at the
library's default width (12 heads x 300, ``config.py``), at 301 (not a
multiple of 4), at the reference's doc-scale tile (16 heads x 200,
``SURVEY.md``) and at the ``large`` preset's 12 x 256, against the JAX
package's XLA path and its Pallas kernels in interpret mode, on the same
numpy-seeded inputs; and the kernels' shape gate, which takes up to 1024
features a head.

Tolerances are the parity chain's (``ROADMAP.md``): propagate forward rtol
1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5 (the bars
``test_pallas.py`` holds the Pallas kernels to); the layer 1e-4, the repo's
activation contract.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu.data.blocked import build_blocked_graph
from relgat_projector_tpu.data.graph import build_graph as jax_build_graph
from relgat_projector_tpu.models.layer import apply_relgat_layer as jax_layer
from relgat_projector_tpu.models.layer import init_relgat_layer
from relgat_projector_tpu.ops.dropout import seed_from_key
from relgat_projector_tpu.ops.pallas import relgat_propagate_pallas
from relgat_projector_tpu.ops.relgat_ops import relgat_propagate as jax_propagate
from relgat_projector_tpu_torch.data.graph import build_graph, pad_node_embeddings
from relgat_projector_tpu_torch.models.layer import apply_relgat_layer
from relgat_projector_tpu_torch.ops import cuda as kern
from relgat_projector_tpu_torch.ops.relgat_ops import relgat_propagate

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
LAYER_TOL = dict(rtol=1e-4, atol=1e-4)
WIDTHS = (300, 301, 200, 256)
HEADS = {200: 16}  # heads at each width: 12 unless named here
DROPOUT_KEY = 5
N, E, R = 90, 500, 5


@functools.lru_cache(maxsize=None)
def _graph():
    rng = np.random.default_rng(21)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    dst[:40] = 3                # a heavy row over several chunks
    dst[40:60] = rng.integers(N - 5, N, 20)
    et = rng.integers(0, R, E)
    return src, dst, et


@functools.lru_cache(maxsize=None)
def _propagate_inputs(feat):
    src, dst, et = _graph()
    g = build_graph(src, dst, et, N, num_rel=R, csr=True, device="cpu")
    rng = np.random.default_rng(feat)
    heads = HEADS.get(feat, 12)
    shape = (g.num_nodes, heads, feat)
    h = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    attn = (rng.standard_normal((heads, R, feat)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(R) * 0.1).astype(np.float32)
    wsum = rng.standard_normal(shape).astype(np.float32)
    return g, h, attn, bias, wsum


@functools.lru_cache(maxsize=None)
def _jax_propagate(feat, path, rate):
    g, h, attn, bias, wsum = _propagate_inputs(feat)
    key = jax.random.PRNGKey(DROPOUT_KEY) if rate else None
    csr = g.csr
    if path == "pallas":
        blocked = build_blocked_graph(
            csr.src.numpy(), csr.dst.numpy(), csr.etype.numpy(),
            num_nodes=g.num_nodes, block_nodes=16, chunk_edges=64)

        def fn(h_, a_, b_):
            return relgat_propagate_pallas(
                h_, a_, b_, blocked, attn_dropout_rate=rate, dropout_rng=key)
    else:
        coo = [jnp.asarray(a.numpy().astype(np.int32))
               for a in (g.src, g.dst, g.etype)]

        def fn(h_, a_, b_):
            return jax_propagate(
                h_, a_, b_, *coo, num_nodes=g.num_nodes,
                attn_dropout_rate=rate, dropout_rng=key,
                edges_sorted_by_dst=True)

    args = [jnp.asarray(x) for x in (h, attn, bias)]
    out = np.asarray(fn(*args))
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a)) * wsum),
                     argnums=(0, 1, 2))(*args)
    return out, [np.asarray(x) for x in grads]


def _port_propagate(feat, use_pallas, rate):
    g, h, attn, bias, wsum = _propagate_inputs(feat)
    seed = int(seed_from_key(jax.random.PRNGKey(DROPOUT_KEY))) if rate else None
    leaves = [torch.tensor(x, requires_grad=True) for x in (h, attn, bias)]
    out = relgat_propagate(
        *leaves, g.src, g.dst, g.etype, num_nodes=g.num_nodes,
        attn_dropout_rate=rate, dropout_seed=seed, use_pallas=use_pallas,
        csr=g.csr)
    (torch.sin(out) * torch.from_numpy(wsum)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves], g


@pytest.mark.parametrize("feat", WIDTHS)
@pytest.mark.parametrize(
    "port,ref,rate",
    [("plain", "xla", 0.0), ("kernels", "pallas", 0.0),
     ("kernels", "pallas", 0.3), ("plain", "xla", 0.3)],
)
def test_wide_propagate_matches_jax(feat, port, ref, rate):
    out, grads, g = _port_propagate(feat, port == "kernels", rate)
    want_out, want_grads = _jax_propagate(feat, ref, rate)
    np.testing.assert_allclose(out, want_out, **FWD_TOL)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got, want, **GRAD_TOL)


@pytest.mark.parametrize("feat", WIDTHS)
@pytest.mark.parametrize("use_pallas", (False, True))
def test_wide_gat_layer_matches_jax(feat, use_pallas):
    """One GAT layer (projection, propagate) at ``HEADS`` x ``feat`` on
    weights from the JAX initialiser, against the JAX layer on the same
    path (real rows: the XLA path gives the padded rows a bias)."""
    src, dst, et = _graph()
    heads = HEADS.get(feat, 12)
    in_dim = 24
    rng = np.random.default_rng(feat + 1)
    emb = rng.standard_normal((N, in_dim)).astype(np.float32)
    jg = jax_build_graph(src, dst, et, N, blocked=use_pallas, block_nodes=16,
                         chunk_edges=64)
    jparams = init_relgat_layer(jax.random.PRNGKey(3), in_dim, feat, R, heads)
    want = np.asarray(jax_layer(
        jparams, jnp.asarray(pad_node_embeddings(emb, jg.num_nodes)), jg,
        use_pallas=use_pallas))
    g = build_graph(src, dst, et, N, num_rel=R, csr=use_pallas, device="cpu")
    params = {k: torch.from_numpy(np.asarray(v)) for k, v in jparams.items()}
    got = apply_relgat_layer(
        params, torch.from_numpy(pad_node_embeddings(emb, g.num_nodes)), g,
        use_pallas=use_pallas).numpy()
    assert got.shape == (g.num_nodes, heads * feat)
    np.testing.assert_allclose(got[:N], want[:N], **LAYER_TOL)


def _gate_inputs(feat, heads=1):
    g = build_graph(np.array([0, 1]), np.array([1, 0]), np.array([0, 0]), 2,
                    num_rel=1, csr=True, device="cpu")
    h = torch.zeros((g.num_nodes, heads * feat))
    return h, torch.zeros((heads, 1, feat)), g.csr


@pytest.mark.parametrize("feat", (300, 301, 512, 1024))
def test_shape_gate_admits_heads_up_to_1024_features(feat):
    h, attn, csr = _gate_inputs(feat)
    assert kern.check_shapes("relgat_fwd", h, attn, csr)[3] == feat
    assert kern.MAX_FEAT == 1024


@pytest.mark.parametrize("feat", (1025, 2048))
def test_shape_gate_names_the_feature_limit(feat):
    h, attn, csr = _gate_inputs(feat)
    with pytest.raises(ValueError, match="limit of 1024.*registers"):
        kern.check_shapes("relgat_fwd", h, attn, csr)


@pytest.mark.parametrize("heads,feat,designs", [
    (16, 128, "LLLL"), (20, 136, "RRLR"), (18, 168, "LRLR"),
    (16, 200, "LRLR"), (13, 232, "LLLR"), (12, 256, "LRLR"),
    (12, 300, "RRRR"), (3, 301, "LLRR"), (8, 384, "RRLR"),
    (3, 448, "LLLL"), (4, 512, "LRLL"), (6, 520, "LRLR"),
    (2, 1024, "LLLR"),
])
def test_wide_heads_take_the_design_of_their_width(heads, feat, designs):
    """Past 128 features the forward and src pass, fp32 and bf16 (in that
    order in ``designs``), take the ring kernel (R) where the card measured
    it faster than the one-warp-a-head template (L), by width and head
    count, and the template elsewhere."""
    wrappers = (kern.relgat_fwd, kern.relgat_bwd_src, kern.relgat_fwd_bf16,
                kern.relgat_bwd_src_bf16)
    got = "".join(kern.design_of(w, heads, feat)[0].upper() for w in wrappers)
    assert got == designs
