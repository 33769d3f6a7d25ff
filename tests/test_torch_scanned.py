"""``scan_segments > 1``: the JAX package's segment-scanned propagate.

JAX scans its fused kernels over dst- and src-range segments
(``relgat_propagate_pallas_scanned`` on a ``build_scanned_graph`` layout) to
bound the E-sized gather streams a TPU keeps live. The port's kernels keep
no E-sized float tensor, so with ``use_pallas`` it accepts the setting and
runs the unsegmented kernels. Held here:

- the port's kernel route on its one CSR layout against JAX's scanned
  propagate over 4 segments, forward and gradients, with and
  without attention dropout (JAX's scanned path hashes global edge ids, so
  its masks are the unscanned path's), at ``test_pallas.py``'s bars:
  forward rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5;
- the dataset builds the same graph with and without it, and a trainer
  and a CLI run with it train to the same bits as without it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu.data.blocked import build_scanned_graph
from relgat_projector_tpu.ops.dropout import seed_from_key
from relgat_projector_tpu.ops.pallas.kernels import (
    relgat_propagate_pallas_scanned,
)
from relgat_projector_tpu_torch import cli
from relgat_projector_tpu_torch.config import ModelConfig
from relgat_projector_tpu_torch.data.dataset import RelGATData
from relgat_projector_tpu_torch.data.graph import build_graph
from relgat_projector_tpu_torch.data.synthetic import generate_synthetic_kg
from relgat_projector_tpu_torch.ops.relgat_ops import relgat_propagate
from relgat_projector_tpu_torch.utils.tree import tree_leaves

from tests.test_torch_trainer import (  # noqa: F401 (a fixture)
    _assert_states_equal,
    _cli_argv,
    _trainer,
    one_thread,
)

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
SEGMENTS = 4
DROPOUT_KEY = 9


def _inputs(seed):
    rng = np.random.default_rng(seed)
    n, e, r, heads, f = 300, 2500, 6, 2, 16
    src, dst, et = (rng.integers(0, n, e), rng.integers(0, n, e),
                    rng.integers(0, r, e))
    g = build_graph(src, dst, et, n, num_rel=r, csr=True, device="cpu")
    n_pad = g.num_nodes
    h = (rng.standard_normal((n_pad, heads, f)) * 0.5).astype(np.float32)
    attn = (rng.standard_normal((heads, r, f)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(r) * 0.1).astype(np.float32)
    wsum = rng.standard_normal((n_pad, heads, f)).astype(np.float32)
    return g, h, attn, bias, wsum


@pytest.mark.parametrize("rate", (0.0, 0.3))
def test_scanned_propagate_matches_jax(rate):
    g, h, attn, bias, wsum = _inputs(int(rate * 10))
    csr = g.csr
    # The JAX layout over the same dst-sorted real edges: edge ids, the
    # dropout hash's key, are positions in that order on both sides.
    sbg = build_scanned_graph(
        csr.src.numpy(), csr.dst.numpy(), csr.etype.numpy(), g.num_nodes,
        SEGMENTS, block_nodes=16, chunk_edges=64)
    key = jax.random.PRNGKey(DROPOUT_KEY) if rate else None

    def jloss(h_, a_, b_):
        out = relgat_propagate_pallas_scanned(
            h_, a_, b_, sbg, attn_dropout_rate=rate, dropout_rng=key)
        return jnp.sum(jnp.sin(out) * wsum), out

    (_, want), want_grads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(h), jnp.asarray(attn), jnp.asarray(bias))

    leaves = [torch.tensor(a, requires_grad=True) for a in (h, attn, bias)]
    out = relgat_propagate(
        *leaves, g.src, g.dst, g.etype, num_nodes=g.num_nodes,
        attn_dropout_rate=rate,
        dropout_seed=int(seed_from_key(key)) if rate else None,
        use_pallas=True, csr=csr,
    )
    (torch.sin(out) * torch.from_numpy(wsum)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    for leaf, w in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   **GRAD_TOL)


def test_dataset_builds_one_layout_with_scan_segments():
    kg = generate_synthetic_kg(num_nodes=200, num_edges=1500, num_rel=3,
                               emb_dim=8, seed=1)
    plain = RelGATData(*kg, seed=2, csr=True, device="cpu")
    scanned = RelGATData(*kg, seed=2, csr=True, scan_segments=SEGMENTS,
                         device="cpu")
    for a, b in ((plain.graph, scanned.graph),
                 (plain.graph.csr, scanned.graph.csr)):
        for name in vars(a):
            x, y = getattr(a, name), getattr(b, name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), name
            elif name != "csr":
                assert x == y, name
    ModelConfig(in_dim=8, num_rel=3, scan_segments=SEGMENTS, use_pallas=True)


@pytest.mark.parametrize("use_pallas", (False, True), ids=("plain", "kernels"))
def test_trainer_with_scan_segments_equals_without(tmp_path, use_pallas,
                                                   one_thread):
    """One epoch each; without ``use_pallas`` the setting is ignored, as in
    the JAX trainer."""
    states = []
    for segments in (0, SEGMENTS):
        tr = _trainer(tmp_path / str(segments), epochs=1,
                      model=dict(use_pallas=use_pallas,
                                 scan_segments=segments))
        tr._single_epoch(1, 1)
        assert tr.model_cfg.scan_segments == segments
        states.append(tr.state)
    assert int(states[0].step) > 0
    _assert_states_equal(*states)


def test_cli_trains_with_scan_segments_to_the_same_parameters(tmp_path,
                                                              one_thread):
    """``--scan-segments`` with ``--use-pallas`` through the CLI: the epoch
    ends at the same bits as without it, and training-config.json records
    the setting."""
    final = "relgat_scorer-distmult_lrscheduler-linear"
    ends = []
    for segments in (0, SEGMENTS):
        out = tmp_path / str(segments)
        cli.main(_cli_argv(out) + ["--scan-segments", str(segments)])
        saved = json.loads((out / final / "training-config.json").read_text())
        assert saved["model"]["scan_segments"] == segments
        ends.append(torch.load(out / final / "relgat-model.pt",
                               weights_only=True))
    for a, b in zip(tree_leaves(ends[1]), tree_leaves(ends[0])):
        assert torch.equal(a, b)
